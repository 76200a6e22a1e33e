"""Hand-written CUDA kernels for Hopper, one package each: ``ops.py`` holds
the public wrapper (kernel on a CUDA tensor, plain version on a CPU one),
``ref.py`` the plain PyTorch versions, ``build.py`` the ctypes binding of
its library (built by ``_build.CudaLibrary``), ``csrc/`` the CUDA sources.

The four kernels, one for each TPU kernel of ``repro``:

* ``flash_attention.flash_attention`` (``csrc/flash_attention.cu``);
* ``moe_gmm.grouped_swiglu`` (``csrc/moe_gmm.cu``);
* ``wkv6.wkv6`` (``csrc/wkv6.cu``);
* ``prefix_scan.prefix_scan`` (``csrc/prefix_scan.cu``).

Besides them ``moe_dispatch`` (``csrc/moe_dispatch.cu``: the MoE layer's
route, dispatch plan, expert-buffer gather and combine) and
``mamba_scan`` (``csrc/mamba_scan.cu``: the Mamba mixer's conv and
selective scan) replace no TPU kernel: XLA fuses those steps of the JAX
package's MoE and Mamba layers.

Import a kernel from its package (``from repro_torch.kernels.wkv6 import
wkv6``): binding the wrappers here would shadow the packages of the same
name.

No kernel has a backward pass: on a CUDA tensor each wrapper refuses
inputs that require grad (``refuse_autograd``) rather than return a result
that silently cuts the gradient.  Training takes the plain path
(``use_flash=False``), as the reference's does.  Nor does any wrapper take
a DTensor (``refuse_dtensor``): a kernel sees one rank's shard only, so the
sharded steps run the plain path too."""
import torch
from torch.distributed.tensor import DTensor

__all__ = ["refuse_autograd", "refuse_dtensor"]


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise where a backward pass could follow a kernel's launch: grad
    enabled and an input (None skipped) requiring grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward pass, and an input "
            f"requires grad; call it under torch.no_grad(), or train on "
            f"the plain path (use_flash=False)")


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise on a DTensor input (None skipped): the kernel takes raw
    pointers to whole tensors, and one rank's shard is not one."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{kernel}: the kernel takes plain tensors, not DTensors; the "
            f"sharded steps run the plain path (use_flash=False)")
