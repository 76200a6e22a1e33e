"""Public wrapper: expert buffers [E, C, D] and stacked expert weights in,
[E, C, D] out.

On a CUDA tensor ``grouped_swiglu`` launches the hand-written kernel
(``csrc/moe_gmm.cu``, two phases) or raises; on a CPU tensor it runs the
plain version (``ref.grouped_swiglu_plain``).  ``grouped_swiglu.launches``
counts the calls that launched the kernel and
``grouped_swiglu.kernel_launches`` the kernels they launched (two a call,
one a phase), and ``grouped_swiglu.route_launches`` the calls by route
(:func:`kernel_route`).

The signature is that of ``repro/kernels/moe_gmm/ops.py`` without its TPU
tiling knobs (``bc``, ``bf``, ``interpret``), plus the dispatch plan's
``load``: the CUDA kernel masks ragged edges instead of padding and skips
the empty rows beyond each expert's load; bf16 picks its own tiles, fp32
takes those of :func:`gmm_plan`, a pure function of the shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import refuse_autograd, refuse_dtensor
from .ref import grouped_swiglu_plain

__all__ = ["grouped_swiglu", "kernel_route", "gmm_plan", "GmmPlan",
           "FP32_TILES", "SLIVERS", "FmaTile", "tile_smem"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = ("fma", "mma")
#: the longest slab the fp32 decode tile covers
DECODE_ROWS = 8
#: the fewest CTAs a phase on the prefill tile may have: one on each of
#: the H100's 132 SMs (its 153 KB of shared memory and 255 registers a
#: thread leave room for one CTA an SM)
TARGET_CTAS = 132
#: the H100's shared memory a CTA may use, bytes
SMEM_LIMIT = 232448


class FmaTile(NamedTuple):
    """One fp32 tile of ``csrc/moe_gmm.cu`` (``FmaTile<...>``): rows, the
    columns of phase (a) (of h: as many of gate and of up) and of phase
    (b), k-groups, k-step and ring stages."""
    bm: int
    bn_glu: int
    bn_down: int
    ks: int
    bk: int
    stages: int

    def smem(self, glu: bool) -> int:
        """Shared memory a CTA takes, bytes: the cp.async ring, or, with
        k-groups, their sums if larger (as the kernel lays them out)."""
        nb, bn = (2, self.bn_glu) if glu else (1, self.bn_down)
        ring = self.stages * (self.bm * (self.bk + 4)
                              + nb * self.bk * (bn + 4)) * 4
        red = self.ks * self.bm * (nb * bn + 4) * 4 if self.ks > 1 else 0
        return max(ring, red)


#: the fp32 tiles by name, in the order of their codes in the C interface
FP32_TILES = {"decode": FmaTile(8, 64, 128, 16, 64, 4),
              "narrow": FmaTile(32, 16, 32, 16, 64, 3),
              "prefill": FmaTile(128, 128, 256, 1, 32, 3)}
#: the tile a row tile of at most ``bm`` live rows takes instead (its
#: columns, k-groups and k-step those of the tile it stands in for, so its
#: rows' k order too); it shares that CTA's shared memory
SLIVERS = {"prefill": FmaTile(32, 128, 256, 1, 32, 3)}
_TILE_CODE = {name: i for i, name in enumerate(FP32_TILES)}


def tile_smem(name: str, glu: bool) -> int:
    """Shared memory a CTA of tile ``name`` takes, its sliver path's too."""
    tiles = [FP32_TILES[name]] + ([SLIVERS[name]] if name in SLIVERS else [])
    return max(t.smem(glu) for t in tiles)


class GmmPlan(NamedTuple):
    """The fp32 tiles of phase (a) (gate and up) and of phase (b) (down)."""
    glu: str
    down: str


def gmm_plan(e: int, c: int, d: int, f: int) -> GmmPlan:
    """The fp32 tiles a call of E experts, C rows, D and F takes.  C <= 8:
    the decode tile (one row tile, each expert's weights read once); else
    the prefill tile, for each phase, unless its grid (E x row tiles x
    column tiles) falls short of TARGET_CTAS, where the narrow tile (32
    rows, an eighth of the columns) takes its place.  A pure function of
    the shapes, never of ``load`` (on the device): a row's k order, and so
    its bits, depend only on the shapes."""
    if min(e, c, d, f) < 1:
        raise ValueError(f"gmm_plan needs positive E, C, D, F; got {e}, {c}"
                         f", {d}, {f}")
    if c <= DECODE_ROWS:
        return GmmPlan("decode", "decode")
    tile = FP32_TILES["prefill"]

    def pick(n: int, bn: int) -> str:
        ctas = e * -(-c // tile.bm) * -(-n // bn)
        return "prefill" if ctas >= TARGET_CTAS else "narrow"
    return GmmPlan(pick(f, tile.bn_glu), pick(d, tile.bn_down))


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (CUDA cores) for fp32, which stays off the tensor cores while
    TF32 is off."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _check_cuda(x, w_gate, w_up, w_down, load) -> None:
    dev = x.device
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.device != dev:
            raise ValueError(f"{name} is on {w.device}, x on {dev}")
        if w.dtype != x.dtype:
            raise TypeError(f"{name} is {w.dtype}, x is {x.dtype}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"grouped_swiglu kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    vec = 16 // x.element_size()
    d, f = x.shape[2], w_gate.shape[2]
    if d % vec or f % vec:
        raise ValueError(f"D={d} and F={f} must be multiples of {vec} for "
                         f"{x.dtype}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if load is not None:
        if load.device != dev or load.dtype != torch.int32 \
                or load.shape != (x.shape[0],) or not load.is_contiguous():
            raise ValueError(f"load must be a contiguous int32 [E] tensor "
                             f"on {dev}")


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor,
                   load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [E, C, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, C, D].

    ``load``: optional [E] int32, expert e's kept rows.  They must be the
    prefix ``[0, load[e])`` of its slab, with zero rows after it (what
    ``priority_dispatch`` and ``gather_expert_inputs`` produce); the kernel
    skips the rows beyond and writes them as zeros.  None = every row."""
    refuse_dtensor("grouped_swiglu", x, w_gate, w_up, w_down, load)
    if x.dim() != 3 or w_gate.dim() != 3 or w_gate.shape != w_up.shape \
            or w_down.dim() != 3:
        raise ValueError(f"x [E,C,D], w_gate/w_up [E,D,F], w_down [E,F,D]; "
                         f"got {tuple(x.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    e, c, d = x.shape
    f = w_gate.shape[2]
    if w_gate.shape[:2] != (e, d) or w_down.shape != (e, f, d):
        raise ValueError(f"mismatched x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, w_gate, w_up, w_down, load)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_swiglu runs on cuda or cpu, not "
                         f"{x.device}")
    refuse_autograd("grouped_swiglu", x, w_gate, w_up, w_down)
    _check_cuda(x, w_gate, w_up, w_down, load)
    from .build import LIBRARY
    lib = LIBRARY.load()
    h = torch.empty(e, c, f, dtype=x.dtype, device=x.device)   # phase (a)
    y = torch.empty_like(x)
    tiles = (-1, -1)                          # bf16 picks its own
    if x.dtype == torch.float32:
        tiles = tuple(_TILE_CODE[t] for t in gmm_plan(e, c, d, f))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.grouped_swiglu_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(),
        None if load is None else load.data_ptr(), h.data_ptr(),
        y.data_ptr(), e, c, d, f, *tiles, stream)
    if code != 0:
        raise RuntimeError("grouped_swiglu launch failed: "
                           + lib.grouped_swiglu_error_string(code).decode())
    grouped_swiglu.launches += 1
    grouped_swiglu.kernel_launches += 2
    grouped_swiglu.route_launches[kernel_route(x.dtype)] += 1
    return y


grouped_swiglu.launches = 0
grouped_swiglu.kernel_launches = 0
grouped_swiglu.route_launches = dict.fromkeys(_ROUTES, 0)
