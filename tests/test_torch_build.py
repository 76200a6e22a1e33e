"""The kernels' build helper: a library's name carries the hash of every
file in its source's directory, so an edited header is rebuilt too.  Runs
on the CPU (nothing is compiled)."""
import ctypes
import re

import pytest

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.flash_attention import build as flash_build
from repro_torch.kernels.mamba_scan import build as mamba_build
from repro_torch.kernels.moe_dispatch import build as dispatch_build
from repro_torch.kernels.moe_gmm import build as gmm_build
from repro_torch.kernels.prefix_scan import build as scan_build
from repro_torch.kernels.wkv6 import build as wkv_build


def _lib(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("constexpr int kTile = 64;\n")
    return CudaLibrary("k", csrc / "k.cu", {}), csrc


def test_digest_changes_with_a_header(tmp_path):
    lib, csrc = _lib(tmp_path)
    before = lib.digest()
    assert lib.digest() == before                  # stable
    (csrc / "k.cuh").write_text("constexpr int kTile = 128;\n")
    assert lib.digest() != before


def test_digest_changes_with_a_new_or_renamed_file(tmp_path):
    lib, csrc = _lib(tmp_path)
    before = lib.digest()
    (csrc / "k.cuh").rename(csrc / "other.cuh")
    renamed = lib.digest()
    assert renamed != before
    (csrc / "extra.cuh").write_text("")
    assert lib.digest() != renamed


@pytest.mark.parametrize("build", [flash_build, gmm_build, scan_build,
                                   wkv_build, dispatch_build, mamba_build])
def test_each_kernel_hashes_its_csrc(build):
    """Every kernel's source lies in its own csrc/, so no two share a hash
    input, and the digest names a 16-hex-digit library."""
    lib = build.LIBRARY
    assert lib.source.parent.name == "csrc" and lib.source.exists()
    d = lib.digest()
    assert len(d) == 16 and int(d, 16) >= 0


_C_TYPES = {"int": ctypes.c_int, "long": ctypes.c_long,
            "float": ctypes.c_float, "void*": ctypes.c_void_p,
            "constvoid*": ctypes.c_void_p}


def _c_params(source: str, fn: str) -> list:
    """The parameter types of ``fn`` as its ``extern "C"`` definition in
    ``source`` declares them (whitespace dropped: "constvoid*", "int")."""
    m = re.search(rf"\b{fn}\s*\(([^)]*)\)", source)
    assert m, f"{fn} not defined in the source"
    types = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()
        types.append("".join(words[:-1]))       # drop the parameter's name
    return types


@pytest.mark.parametrize("build", [flash_build, gmm_build, scan_build,
                                   wkv_build, dispatch_build, mamba_build])
def test_c_signatures_match_the_source(build):
    """Every function a library declares to ctypes has, argument by
    argument, the C types of its definition in the .cu file: a pointer
    declared c_int would be cut to 32 bits, a missing argument would shift
    every later one."""
    source = build.LIBRARY.source.read_text()
    for fn, (argtypes, _) in build.LIBRARY.signatures.items():
        assert argtypes == [_C_TYPES[t] for t in _c_params(source, fn)], fn
