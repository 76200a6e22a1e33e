"""Shape-and-dtype stand-ins for every (architecture x input-shape) cell:
the PyTorch counterpart of ``repro/launch/input_specs.py``.

Where the reference returns ``jax.ShapeDtypeStruct``s, the port returns
tensors on the ``meta`` device: the same shapes and dtypes, and no storage.
Shapes follow the assignment:

    train_4k     seq_len=4,096   global_batch=256   (train_step)
    prefill_32k  seq_len=32,768  global_batch=32    (serve prefill)
    decode_32k   seq_len=32,768  global_batch=128   (serve decode: 1 token,
                                                     KV cache of seq_len)
    long_500k    seq_len=524,288 global_batch=1     (long-context decode;
                                                     SSM/hybrid/SWA only)

VLM cells reserve ``num_image_tokens`` of the sequence for the (stub)
frontend's precomputed patch embeddings; encdec cells split the sequence
half source embeddings (stub audio frontend) / half target tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig

__all__ = ["SHAPES", "ShapeCell", "input_specs", "cell_is_applicable",
           "train_microbatches", "shape_by_name"]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic context (SSM / hybrid / SWA)."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full attention at 524k context: unbounded KV cache; "
                       "skipped per assignment (see DESIGN.md)")
    return True, ""


def train_microbatches(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Gradient-accumulation factor bounding activation memory."""
    if cell.kind != "train":
        return 1
    tokens = cell.seq_len * cell.global_batch
    # target <= ~128k tokens per microbatch for the wide models
    if cfg.d_model >= 4096 or cfg.num_experts >= 64:
        return max(1, tokens // 131_072)
    return max(1, tokens // 262_144)


def _i32(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f(shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    """The cell's batch as ``meta`` tensors.

    train   -> the batch dict for train_step
    prefill -> the batch dict for model.prefill
    decode  -> {"token": [B, 1]} (the cache's shapes come from
               ``model.init_cache``)
    """
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"token": _i32((b, 1))}
    if cfg.family == "vlm":
        s_text = s - cfg.num_image_tokens
        batch = {"tokens": _i32((b, s_text)),
                 "image_embeds": _f((b, cfg.num_image_tokens,
                                     cfg.vision_embed_dim))}
        if cell.kind == "train":
            batch["labels"] = _i32((b, s_text))
        return batch
    if cfg.family == "encdec":
        half = s // 2
        batch = {"src_embeds": _f((b, half, cfg.audio_embed_dim)),
                 "tokens": _i32((b, half))}
        if cell.kind == "train":
            batch["labels"] = _i32((b, half))
        return batch
    batch = {"tokens": _i32((b, s))}
    if cell.kind == "train":
        batch["labels"] = _i32((b, s))
    return batch
