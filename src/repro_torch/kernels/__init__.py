"""Hand-written CUDA kernels for Hopper, one package each: ``ops.py`` holds
the public wrapper (kernel on a CUDA tensor, plain version on a CPU one),
``ref.py`` the plain PyTorch versions, ``build.py`` the ctypes binding of
its library (built by ``_build.CudaLibrary``), ``csrc/`` the CUDA sources.
Import a kernel from its package (``from repro_torch.kernels.flash_attention
import flash_attention``) so that the package name stays the package."""
