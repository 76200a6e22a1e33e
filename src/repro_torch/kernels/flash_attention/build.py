"""Build and load the flash-attention CUDA library.

``nvcc`` compiles ``csrc/flash_attention.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build happens
at first use, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries the source's hash: an edited
source is rebuilt, an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

__all__ = ["SOURCE", "build_library", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the flash-attention kernel is "
                           "built on a machine with the CUDA toolkit")
    return found


def build_library() -> tuple[Path, float, str]:
    """Compile the library if its hashed name is not built yet.  Returns
    (path, build seconds (0 when already built), nvcc's output)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libflash_attention-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, seconds, log


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C signatures."""
    global _lib
    if _lib is None:
        path, _, _ = build_library()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, i,
                                            i, i, i, i, ctypes.c_float, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
