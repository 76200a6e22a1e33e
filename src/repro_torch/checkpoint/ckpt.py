"""Checkpointing: async save off the critical path, atomic publication,
restore onto a target device: the PyTorch counterpart of
``repro/checkpoint/ckpt.py``, in its format.

Format: one ``.npz`` per checkpoint holding every leaf keyed by its tree
path (``params/blocks/attn/wq/w``, ``opt/.step``, ``opt/.m/embed/table``:
``tree.tree_leaves_with_path``), plus a JSON manifest.  bf16 leaves are
stored as raw 2-byte ``|V2`` records, as ``np.savez`` stores the
reference's ``ml_dtypes`` bfloat16, so each package reads the other's
checkpoints.  Saves write to a temp dir then rename: a crashed save never
corrupts the latest checkpoint.  ``restore`` takes a target device where the
reference takes shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_leaves_with_path, tree_map, tree_map_with_path

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf (a tensor, or anything ``np.asarray`` takes);
    bf16 as ``|V2`` records of its bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree) -> dict:
    return {k: _to_numpy(leaf) for k, leaf in tree_leaves_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    final = os.path.join(directory, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"), **_flatten(tree))
    manifest = {"step": step, "time": time.time(), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on ``device`` (None:
    ``like``'s device)."""
    device = like.device if device is None else device
    if arr.dtype.kind == "V":
        # bfloat16 round-trips as raw bytes
        if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise TypeError(f"raw {arr.dtype.itemsize}-byte leaf for a "
                            f"{like.dtype} template leaf")
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(arr, order="C")).to(device=device,
                                                           dtype=like.dtype)


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None, device=None):
    """Returns (tree, manifest): ``template``'s structure (a tree of
    tensors), each leaf of its template leaf's dtype, on ``device`` (None:
    each template leaf's own device)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = {k: data[k] for k in data.files}

    def leaf(key, like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _to_tensor(flat[key], like, device)

    tree = tree_map_with_path(leaf, template)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return tree, manifest


class CheckpointManager:
    """Async checkpointing: ``save`` returns immediately; the write happens
    on a worker thread (off the training critical path).  ``wait`` joins
    the in-flight save; saves are serialized; keeps the last ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        # copy to host memory synchronously (the caller may update the
        # tensors in place right after), write async
        host_tree = tree_map(_to_numpy, tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - re-raised by wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Any, device=None):
        self.wait()
        return restore_checkpoint(self.directory, template, device=device)

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1])
                       for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
