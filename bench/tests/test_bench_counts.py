"""The frozen counts reproduce hand-worked bounds at the kernel table's
shapes (grouped SwiGLU and flash decode on the H100: bytes at 3.35 TB/s,
FLOPs at 989 TFLOP/s in bf16) and the published active parameters."""
import pytest

from bench.counts.flash import decode_bound_s, decode_work
from bench.counts.gmm import gmm_bound_s, gmm_work
from bench.counts.step import (chunk_flops, decode_flops,
                               layer_params_per_token, token_flops)
from bench.families.transformer import sizes_of
from bench.harness.registry import BENCH_DIR

import json


def _sizes(name):
    return sizes_of(json.loads((BENCH_DIR / "configs" / f"{name}.json")
                               .read_text()))


def test_gmm_mixtral_decode_bound():
    # E=8 C=8 D=6144 F=16384, load [2,1,2,0,5,1,1,4]: 7 experts' weights
    # (7 * 3 * 6144 * 16384 * 2 bytes), 16 rows in, 64 rows out
    loads = [2, 1, 2, 0, 5, 1, 1, 4]
    flops, nbytes = gmm_work(8, 8, 6144, 16384, loads)
    assert nbytes == 7 * 3 * 6144 * 16384 * 2 + 16 * 6144 * 2 \
        + 64 * 6144 * 2
    assert flops == 6 * 16 * 6144 * 16384
    assert round(gmm_bound_s(8, 8, 6144, 16384, loads) * 1e3, 3) == 1.262


def test_gmm_prefill_is_bytes_or_ops_bound():
    # C=1024 with ~256 rows an expert: bytes 1.480 ms, ops 1.25 ms
    loads = [256] * 8
    assert round(gmm_bound_s(8, 1024, 6144, 16384, loads) * 1e3, 2) == 1.48
    flops, _ = gmm_work(8, 1024, 6144, 16384, loads)
    assert round(flops / 989e12 * 1e3, 2) == 1.25


@pytest.mark.parametrize("heads,kv,want_ms", [
    # Mixtral 48/8, B=8 T=1024 (kv_valid of the kernel table's row)
    (48, [65, 1024, 130, 513, 1, 300, 700, 529], 0.00405),
    # Mistral-Large 96/8, B=8 T=2048
    (96, [65, 2048, 130, 1025, 1, 300, 1700, 529], 0.00721)])
def test_split_decode_bound(heads, kv, want_ms):
    flops, nbytes = decode_work(heads, 8, 128, kv)
    assert nbytes == 2 * 8 * heads * 128 * 2 + 2 * sum(kv) * 8 * 128 * 2
    assert flops == 4 * 128 * heads * sum(kv)
    assert round(decode_bound_s(heads, 8, 128, kv) * 1e3, 5) == want_ms


def test_active_parameters():
    # Mixtral-8x22B: ~39B active a token over 56 layers (published)
    s = _sizes("mixtral-8x22b-l8")
    per = layer_params_per_token(s)
    assert per == 6144 * 8192 + 48 * 128 * 6144 + 2 * 3 * 6144 * 16384 \
        + 6144 * 8
    assert 38.9e9 < 56 * per + 2 * 32768 * 6144 < 39.3e9
    # Mistral-Large 2: 123B over 88 layers
    s = _sizes("mistral-large-123b-l22")
    assert 122e9 < 88 * layer_params_per_token(s) + 2 * 32768 * 12288 \
        < 124e9


@pytest.mark.parametrize("window", [None, 3, 5, 100])
def test_chunk_flops_is_the_sum_of_its_tokens(window):
    s = dict(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4, d_ff=16,
             num_experts=0, top_k=0, num_layers=2, vocab_size=10,
             sliding_window=window)
    for start, n in [(0, 1), (0, 7), (2, 5), (4, 9), (10, 3)]:
        assert chunk_flops(s, start, n) == sum(
            token_flops(s, p, p == start + n - 1)
            for p in range(start, start + n))
    assert decode_flops(s, [0, 4]) == token_flops(s, 0, True) \
        + token_flops(s, 4, True)
