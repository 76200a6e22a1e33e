"""Collective traffic, FLOPs and bytes of a traced step, per device.

The PyTorch counterpart of ``repro/launch/hlo_stats.py``, which reads the
collectives out of XLA's compiled HLO.  PyTorch makes no HLO: DTensor issues
each collective itself, as a ``_c10d_functional`` op on this rank's local
shard.  ``TraceCounter``, a ``TorchDispatchMode``, sees every op that runs
on local tensors while a step runs (DTensor ops are handed back to DTensor,
which dispatches their local ops through the mode again; ops on fake
tensors, DTensor's shape propagation, are skipped) and records:

* each collective's kind and operand bytes (``collective_bytes``);
* FLOPs, by ``torch.utils.flop_counter``'s formulas;
* bytes accessed: every non-view op's input and output bytes.  Nothing is
  fused here, so this is an upper bound on the traffic, as XLA's count on
  the CPU is an upper bound of the TPU's fused one.

All tensors are local shards, so every number is per device, as the
reference's are.  On a mesh of device type ``cpu`` (the fake world's),
DTensor moves shard-to-shard layouts with an all-gather and a local chunk
instead of an all-to-all (PyTorch's CPU fallback), so such bytes appear
under ``all-gather``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["collective_bytes", "DTYPE_BYTES", "TraceCounter"]

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "token": 0,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")

#: collective ops (functional, as DTensor issues them, and in-place c10d
#: ones, as ``torch.distributed`` calls issue them) -> the reference's kind
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-broadcast",
    "_c10d_functional.broadcast_": "collective-broadcast",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-broadcast",
    "c10d.send": "collective-permute",
}
#: ops that move no data of their own
_FREE = ("_c10d_functional.wait_tensor",
         "_c10d_functional._wrap_tensor_autograd", "aten.detach",
         "aten.lift_fresh")


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (lists, tuples and
    dicts of them)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class TraceCounter(TorchDispatchMode):
    """Counts, while active, the local ops of everything that runs:
    ``records`` (collective kind, operand bytes), ``flops`` and
    ``bytes_accessed``."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, int]] = []
        self.flops = 0
        self.bytes_accessed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's shape propagation, not a step op
        op = f"{func.namespace}.{func._opname}"
        kind = _KIND.get(op)
        if kind is not None:
            self.records.append((kind, sum(_bytes(t) for t in ins)))
            return out
        if op in _FREE or func.is_view:
            return out
        self.bytes_accessed += sum(_bytes(t) for t in ins + outs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


def collective_bytes(records) -> Dict[str, int]:
    """Per-device operand bytes per collective kind (plus 'total'), from
    ``TraceCounter.records``."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += nbytes
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out
