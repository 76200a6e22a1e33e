"""Build and load a kernel's CUDA library.

``nvcc`` compiles one ``csrc/*.cu`` file for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build happens
at first use, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries the hash of every file in the
source's directory (the ``.cu`` and any header it includes from there): an
edited source or header is rebuilt, an unchanged one is loaded as it is.
The library is written under a temporary name and renamed into place, so
builds started together (threads or processes) never load a half-written
file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["CudaLibrary", "BUILD_DIR"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


class CudaLibrary:
    """One kernel's library: its source, and the C signatures to declare
    (``{function: (argtypes, restype)}``) once it is loaded."""

    def __init__(self, name: str, source: Path, signatures: dict):
        self.name, self.source, self.signatures = name, source, signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def digest(self) -> str:
        """Hash of every file beside the source (names and contents)."""
        h = hashlib.sha256()
        for path in sorted(p for p in self.source.parent.rglob("*")
                           if p.is_file()):
            h.update(str(path.relative_to(self.source.parent)).encode())
            h.update(b"\0")
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    def build(self) -> tuple[Path, float, str]:
        """Compile the library if its hashed name is not built yet.  Returns
        (path, build seconds (0 when already built), nvcc's output)."""
        digest = self.digest()
        out = BUILD_DIR / f"lib{self.name}-{digest}.so"
        if out.exists():
            return out, 0.0, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                               str(self.source)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, out)
        return out, seconds, log

    def load(self) -> ctypes.CDLL:
        """Build if needed, load once, and declare the C signatures."""
        with self._lock:
            if self._lib is None:
                path, _, _ = self.build()
                lib = ctypes.CDLL(str(path))
                for fn, (argtypes, restype) in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                self._lib = lib
            return self._lib
