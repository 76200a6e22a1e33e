"""PyTorch/CUDA port of ``repro``: paged LLM serving under the strategy
scheduler, with hand-written CUDA kernels for NVIDIA Hopper.

The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``: the JAX-free modules it needs are copies at mirrored paths.
Entry points run on CUDA unless the caller asks for the CPU.
"""
