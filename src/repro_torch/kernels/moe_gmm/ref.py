"""Plain PyTorch version of the grouped SwiGLU kernel: what
``repro/kernels/moe_gmm/ref.py::grouped_swiglu_ref`` computes."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["grouped_swiglu_plain"]


def grouped_swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor, w_down: torch.Tensor,
                         load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [E, C, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, C, D].

    Both products accumulate in fp32 (the operands are widened, so a bf16
    product is exact before the sum); ``h`` is cast to ``x.dtype`` before
    the down projection and the output to ``x.dtype``.  ``load`` is taken
    and ignored: rows beyond it are zero, and give zero."""
    del load
    g = torch.bmm(x.float(), w_gate.float())
    u = torch.bmm(x.float(), w_up.float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.bmm(h.float(), w_down.float()).to(x.dtype)
