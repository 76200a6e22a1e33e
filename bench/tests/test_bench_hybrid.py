"""The hybrid family (``bench/families/hybrid.py``) and its reference
(``bench/reference/hybrid.py``), on the CPU:

* the weight tree is the port's ``init_hybrid_lm`` tree, path for path,
  shape for shape and type for type;
* the model FLOPs against a count by hand, and two attention layers in 16;
* a file the port cannot serve is refused;
* a tiny hybrid cell added as new files runs, traced, with the chunk path
  carrying the Mamba state, and the two Mamba readers read numbers from
  its program slice and None untraced;
* with the carried state zeroed at every chunk boundary, the comparison
  reads a larger gap than sound;
* neither file imports the program or JAX.
"""
import ast
import json

import pytest

from bench.families import hybrid
from bench.harness import runner
from bench.harness.registry import BENCH_DIR, load_cell, load_reader
from bench.harness.weights import make_weights
from bench.tests._tiny import add_cell, add_config, tiny_cell, tiny_tree

CONFIG = json.loads((BENCH_DIR / "configs" / "jamba2-mini-l16.json")
                    .read_text())
TINY = dict(CONFIG, name="tiny-hybrid", hidden_size=64,
            intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, num_hidden_layers=8,
            vocab_size=512, num_experts=4, mamba_dt_rank=8,
            mamba_d_state=8, attn_layer_period=4, attn_layer_offset=2)
READERS = ("mamba_decode_issue_ms", "mamba_prefill_issue_ms_per_ktok")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tuple(tree.shape), tree.dtype


def _port(config):
    from repro_torch.models import build_model
    cfg = runner.port_config(hybrid, config).replace(use_flash=False)
    return build_model(cfg, "cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_leaf_specs_are_the_ports_tree(dtype):
    conf = dict(TINY, torch_dtype=dtype)
    sizes = hybrid.sizes_of(conf)
    want = sorted(_leaves(_port(conf).init(0)), key=str)
    got = sorted(_leaves(make_weights(hybrid, sizes, 1, "cpu")), key=str)
    assert got == want


def test_port_fields_are_jambas_equations():
    cfg = runner.port_config(hybrid, CONFIG)
    assert (cfg.num_layers, cfg.attn_every, cfg.attn_index,
            cfg.moe_layer_period) == (16, 8, 4, 2)
    assert (cfg.mamba_dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv,
            cfg.mamba_d_inner, cfg.norm_eps) == (256, 16, 4, 8192, 1e-6)
    assert cfg.mamba_inner_norm and not cfg.moe_renormalize
    assert cfg.rope_theta == 0.0 and cfg.sliding_window is None


@pytest.mark.parametrize("key,value", [
    ("expert_layer_offset", 0), ("mamba_proj_bias", True),
    ("mamba_conv_bias", False), ("tie_word_embeddings", True),
    ("hidden_act", "gelu"), ("sliding_window", 4096)])
def test_a_file_the_port_cannot_serve_is_refused(key, value):
    with pytest.raises(ValueError, match=key):
        hybrid.port_fields(dict(CONFIG, **{key: value}))


def test_attention_layers_and_counts_by_hand():
    s = hybrid.sizes_of(CONFIG)
    assert hybrid.attention_layers(s) == 2
    d, f, v = 4096, 14336, 65536
    di, ds, dc, dtr = 8192, 16, 4, 256
    mamba_params = d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
    attn_params = d * (32 + 16) * 128 + 32 * 128 * d
    moe_params = 2 * 3 * d * f + d * 16
    mlp_params = 3 * d * f
    start, n = 300, 7
    keys = sum(start + j + 1 for j in range(n))
    # 14 Mamba, 2 attention; 8 MoE, 8 dense; the head for the last row
    want = (14 * n * (2 * mamba_params + 2 * dc * di + 9 * di * ds
                      + 3 * di)
            + 2 * (n * 2 * attn_params + 4 * 128 * 32 * keys)
            + 8 * n * 2 * moe_params + 8 * n * 2 * mlp_params
            + 2 * d * v)
    assert hybrid.chunk_flops(s, start, n) == want
    assert hybrid.decode_flops(s, [4, 9]) == \
        hybrid.chunk_flops(s, 4, 1) + hybrid.chunk_flops(s, 9, 1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("hybrid") / "checkout")
    add_config(root, TINY)
    add_cell(root, tiny_cell("tiny-hybrid.chat", "tiny-hybrid",
                             rate_per_s=3.0))
    return root


def test_tiny_hybrid_cell_runs_traced(tree):
    cell = load_cell("tiny-hybrid.chat", tree)
    assert cell.family.__name__.endswith("hybrid")
    w = cell.workload
    model, weights, sizes = runner.setup(cell, 2**31 + 11, "cpu")
    rec, eng = runner.serve(cell, model, weights, sizes, 2**31 + 11, 2.0,
                            True, float(w["lead_in_s"]),
                            float(w["drain_cap_s"]))
    assert eng.io_stats["mamba_states_committed"] > 0
    assert eng.io_stats["mamba_staged_bytes"] >= 0
    names = {s.name for s in rec.spans}
    assert {"model.decode", "mamba.decode"} <= names
    got = {m: load_reader(m)(rec) for m in READERS}
    assert isinstance(got["mamba_decode_issue_ms"], float) \
        and got["mamba_decode_issue_ms"] > 0
    if "mamba.prefill" in names:
        assert got["mamba_prefill_issue_ms_per_ktok"] > 0
    rec, _ = runner.serve(cell, model, weights, sizes, 5, 1.0, False,
                          float(w["lead_in_s"]), float(w["drain_cap_s"]))
    assert rec.spans == []
    assert all(load_reader(m)(rec) is None for m in READERS)


def _zero_at_chunks(orig):
    """The hybrid's chunk with the carried h zeroed at every chunk
    boundary (a chunk past position 0 starts from no history)."""
    def chunk(params, batch, cache, row, start, cfg):
        if int(start) > 0:
            batch["mamba_state"].h.zero_()
        return orig(params, batch, cache, row, start, cfg)
    return chunk


def test_state_dropped_at_chunks_reads_a_larger_gap(tree, monkeypatch):
    cell = load_cell("tiny-hybrid.chat", tree)
    cell.workload = dict(cell.workload, compare={
        "served": 64, "requests": 4, "limits": {}})
    sound = runner.run_cell(cell, 31, 2.0, False, "cpu",
                            log=lambda s: None)
    from repro_torch.models import hybrid as port_hybrid
    monkeypatch.setattr(port_hybrid, "hybrid_prefill_chunk_paged",
                        _zero_at_chunks(
                            port_hybrid.hybrid_prefill_chunk_paged))
    broken = runner.run_cell(cell, 31, 2.0, False, "cpu",
                             log=lambda s: None)
    assert broken["numbers"]["gap_mean"] > 2 * sound["numbers"]["gap_mean"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_family_and_reference_import_neither_program_nor_jax():
    for rel in ("families/hybrid.py", "reference/hybrid.py"):
        names = set(_imports(BENCH_DIR / rel))
        assert not names & {"repro_torch", *runner.FORBIDDEN}, rel
    assert set(_imports(BENCH_DIR / "reference" / "hybrid.py")) <= {
        "__future__", "math", "typing", "torch"}
    assert hybrid.forward_logits.__module__ == "bench.reference.hybrid"
