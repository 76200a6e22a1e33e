"""Hand-written CUDA kernels for Hopper, one package each: ``ops.py`` holds
the public wrapper (kernel on a CUDA tensor, plain version on a CPU one),
``ref.py`` the plain PyTorch versions, ``build.py`` the ctypes binding of
its library (built by ``_build.CudaLibrary``), ``csrc/`` the CUDA sources.

The four kernels, one for each TPU kernel of ``repro``:

* ``flash_attention.flash_attention`` (``csrc/flash_attention.cu``);
* ``moe_gmm.grouped_swiglu`` (``csrc/moe_gmm.cu``);
* ``wkv6.wkv6`` (``csrc/wkv6.cu``);
* ``prefix_scan.prefix_scan`` (``csrc/prefix_scan.cu``).

Import a kernel from its package (``from repro_torch.kernels.wkv6 import
wkv6``): binding the wrappers here would shadow the packages of the same
name."""
