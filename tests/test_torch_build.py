"""The kernels' build helper: a library's name carries the hash of every
file in its source's directory, so an edited header is rebuilt too.  Runs
on the CPU (nothing is compiled)."""
import pytest

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.flash_attention import build as flash_build
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
                                   wkv_build])
def test_each_kernel_hashes_its_csrc(build):
    """Every kernel's source lies in its own csrc/, so no two share a hash
    input, and the digest names a 16-hex-digit library."""
    lib = build.LIBRARY
    assert lib.source.parent.name == "csrc" and lib.source.exists()
    d = lib.digest()
    assert len(d) == 16 and int(d, 16) >= 0
