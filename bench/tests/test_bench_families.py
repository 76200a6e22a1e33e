"""Architecture families (``bench/families``), on the CPU:

* the transformer family reproduces, bit for bit, what the harness gave
  before it read the architecture from a family: the weights leaf by leaf,
  the reference's logits (the program's comparison and the float8
  control's) and the model FLOPs and flash decode bounds.  The digests
  were taken at the commit before families, with one intra-op thread;
* a family, a configuration and a cell added as new files are found by
  name and run, and no file of the copy they were added to changes;
* a family's reference that loads JAX stops the run with no result, and
  every family's reference is defined under ``bench/reference``;
* the flash decode bound counts the family's attention layers only;
* the harness's general files name no family and no model.
"""
import hashlib
import json
import sys
from types import SimpleNamespace

import pytest
import torch

from bench.families import transformer
from bench.harness import runner
from bench.harness.registry import BENCH_DIR, load_cell, load_family
from bench.harness.tracing import flash_decode_bound_s
from bench.harness.weights import make_weights
from bench.tests._tiny import (TINY_DENSE, TINY_MOE, add_cell,
                               add_config, tiny_cell, tiny_tree)

#: sha256 (first 16 hex digits) of each leaf's bits, seed 3
WEIGHTS = {
    "moe": {
        "/embed/table": "04b102060211b138",
        "/blocks/ln1/scale": "f9bb0321cf43a5fe",
        "/blocks/attn/wq/w": "816bb04f0379b5bb",
        "/blocks/attn/wk/w": "295d3956441cf879",
        "/blocks/attn/wv/w": "cb0a92f4aef9d9c5",
        "/blocks/attn/wo/w": "e8127c9f69f23c08",
        "/blocks/ln2/scale": "a2868c984f9f59c9",
        "/blocks/moe/router/w": "0353c0664d6247f0",
        "/blocks/moe/w_gate": "6429287d6b03fbbb",
        "/blocks/moe/w_up": "fc3e73004dc17547",
        "/blocks/moe/w_down": "12b0343d94796f4a",
        "/ln_f/scale": "552352974f7d6544",
        "/lm_head/w": "553376d5585a018c"},
    "dense": {
        "/embed/table": "04b102060211b138",
        "/blocks/ln1/scale": "f9bb0321cf43a5fe",
        "/blocks/attn/wq/w": "c59254cce5ed6459",
        "/blocks/attn/wk/w": "43a3b6b17d2e0723",
        "/blocks/attn/wv/w": "324b5a78dcf866ed",
        "/blocks/attn/wo/w": "919b24bd96b834ce",
        "/blocks/ln2/scale": "2b62666d381a12c2",
        "/blocks/mlp/gate/w": "b11909f0b21551c7",
        "/blocks/mlp/up/w": "64b1255439236ce4",
        "/blocks/mlp/down/w": "32ac6cdde066e8ae",
        "/ln_f/scale": "4782228c836eb0c3",
        "/lm_head/w": "a37141b98e01012c"}}
#: the reference's logits of two sequences (40 and 23 tokens, rows 0.. and
#: 5..) on the weights of seed 11, fp32 and the float8 control
LOGITS = {"moe/None": "1e867f58b56588a1", "moe/fp8": "2a811000fde550bb",
          "dense/None": "fa59f3d28041d7ca", "dense/fp8": "bd59b79a4e99b476",
          "moe_window/None": "888eccb553a3d219",
          "moe_window/fp8": "556320c7ea96c3c7"}
#: the 720 counts of ``_count_grid``
COUNTS = "b7192a82dbba052b"
CONFIGS = {"moe": TINY_MOE, "dense": TINY_DENSE,
           "moe_window": dict(TINY_MOE, sliding_window=16)}


def _digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    b = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(b.numpy().tobytes()).hexdigest()[:16]


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_transformer_weights_are_the_parents(name, one_thread):
    w = make_weights(transformer,
                     transformer.sizes_of(CONFIGS[name]), 3, "cpu")
    assert {p: _digest(t) for p, t in _leaves(w)} == WEIGHTS[name]
    assert [p for p, _ in _leaves(w)] == list(WEIGHTS[name])


@pytest.mark.parametrize("key", list(LOGITS))
def test_transformer_reference_is_the_parents(key, one_thread):
    name, quant = key.split("/")
    s = transformer.sizes_of(CONFIGS[name])
    w = make_weights(transformer, s, 11, "cpu")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, 512, (n,), generator=g) for n in (40, 23)]
    ref = transformer.forward_logits(w, s, seqs, [0, 5],
                                     quant=None if quant == "None" else quant)
    assert hashlib.sha256(b"".join(r.numpy().tobytes() for r in ref)) \
        .hexdigest()[:16] == LOGITS[key]


def _count_grid(fam) -> list:
    """Chunk, decode and flash decode counts of both real configurations
    and the tiny ones, windowed as configured, without a window and at a
    window of 300."""
    cfgs = [json.loads((BENCH_DIR / "configs" / f).read_text())
            for f in ("mixtral-8x22b-l8.json", "mistral-large-123b-l22.json")]
    vals = []
    for cfg in cfgs + [TINY_MOE, TINY_DENSE]:
        for window in ("as is", None, 300):
            c = dict(cfg) if window == "as is" \
                else dict(cfg, sliding_window=window)
            s = fam.sizes_of(c)
            for start in (0, 1, 7, 299, 300, 511, 1000, 4095, 5000):
                for n in (1, 16, 300, 512, 1024, 3072):
                    vals.append(fam.chunk_flops(s, start, n))
            for pos in ([0], [5, 4095], list(range(0, 6000, 97)),
                        [299, 300, 301]):
                vals.append(fam.decode_flops(s, pos))
            calls = [[1], [1, 4096, 300], list(range(1, 4097, 131)),
                     [0, 0, 7]]
            vals.append(flash_decode_bound_s(fam, s, calls))
            vals.append(flash_decode_bound_s(fam, s, calls[:1]))
    return vals


def test_transformer_counts_are_the_parents():
    vals = _count_grid(transformer)
    assert len(vals) == 720
    assert hashlib.sha256(json.dumps(vals).encode()).hexdigest()[:16] \
        == COUNTS


def test_flash_bound_counts_attention_layers_only():
    s = dict(transformer.sizes_of(TINY_MOE), num_layers=16)
    hybrid = SimpleNamespace(attention_layers=lambda sizes: 2)
    calls = [[1, 4096, 300], list(range(1, 2049, 77)), [5]]
    whole = flash_decode_bound_s(transformer, s, calls)
    assert transformer.attention_layers(s) == 16
    assert flash_decode_bound_s(hybrid, s, calls) == whole / 8 > 0


def test_weights_draw_list_trees():
    fam = SimpleNamespace(leaf_specs=lambda s: [
        (("a", "layers", 1, "w"), (2, 3), None, 0.0, 1.0),
        (("a", "layers", 0, "w"), (3,), "float32", 1.0, 0.1),
        (("b",), (4,), None, 0.0, 1.0)])
    w = make_weights(fam, {"dtype": "bfloat16"}, 9, "cpu")
    layers = w["a"]["layers"]
    assert isinstance(layers, list) and len(layers) == 2
    assert layers[1]["w"].shape == (2, 3) \
        and layers[1]["w"].dtype == torch.bfloat16
    assert layers[0]["w"].dtype == torch.float32
    assert w["b"].shape == (4,)
    again = make_weights(fam, {"dtype": "bfloat16"}, 9, "cpu")
    assert torch.equal(again["a"]["layers"][0]["w"], layers[0]["w"])


#: a family of configurations in Mistral's own ``params.json`` keys, for
#: the discovery test: it reads no Hugging Face key, so a run that serves
#: it took its sizes and the port's fields from this file, and it counts
#: the calls of the harness into it
PARAMS_FAMILY = '''
from bench.families import transformer

CALLS = {}
_HF = {"dim": "hidden_size", "hidden_dim": "intermediate_size",
       "n_heads": "num_attention_heads", "n_kv_heads": "num_key_value_heads",
       "head_dim": "head_dim", "n_layers": "num_hidden_layers",
       "vocab_size": "vocab_size", "rope_theta": "rope_theta",
       "norm_eps": "rms_norm_eps", "sliding_window": "sliding_window",
       "dtype": "torch_dtype"}


def _counted(name, fn):
    def call(*args, **kw):
        CALLS[name] = CALLS.get(name, 0) + 1
        return fn(*args, **kw)
    return call


def _hf(config):
    out = {hf: config[k] for k, hf in _HF.items() if k in config}
    moe = config.get("moe")
    if moe:
        out["num_local_experts"] = moe["num_experts"]
        out["num_experts_per_tok"] = moe["num_experts_per_tok"]
    return out


port_fields = _counted("port_fields",
                       lambda c: transformer.port_fields(_hf(c)))
sizes_of = _counted("sizes_of", lambda c: transformer.sizes_of(_hf(c)))
for _name in ("leaf_specs", "forward_logits", "chunk_flops",
              "decode_flops", "attention_layers"):
    globals()[_name] = _counted(_name, getattr(transformer, _name))
'''
TINY_PARAMS = {"name": "tiny-params", "arch": "mixtral-8x22b",
               "family": "mistral_params", "source": "test", "dim": 64,
               "hidden_dim": 128, "n_heads": 4, "n_kv_heads": 2,
               "head_dim": 16, "n_layers": 2, "vocab_size": 512,
               "rope_theta": 1000000.0, "norm_eps": 1e-05,
               "sliding_window": 4096, "dtype": "bfloat16",
               "moe": {"num_experts": 4, "num_experts_per_tok": 2}}


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_family_needs_no_edit(tmp_path):
    root = tiny_tree(tmp_path / "checkout")
    before = _files(root)
    spec_before = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench" / "families" / "mistral_params.py").write_text(
        PARAMS_FAMILY)
    add_config(root, TINY_PARAMS)
    add_cell(root, tiny_cell("tiny-params.chat", "tiny-params"))
    cell = load_cell("tiny-params.chat", root)
    assert cell.family.__file__ == str(
        root / "bench" / "families" / "mistral_params.py")
    out = runner.run_cell(cell, 8, 2.0, True, "cpu", log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["numbers"]["served_tokens"] > 0
    assert out["metrics"]["step_mfu"]["value"] > 0
    calls = cell.family.CALLS
    for name in ("port_fields", "sizes_of", "leaf_specs", "forward_logits",
                 "chunk_flops", "decode_flops"):
        assert calls.get(name), (name, calls)
    # every file the copy started with is as it was; BENCHMARK.json only
    # gained entries
    after = _files(root)
    assert {p: after[p] for p in before} == before
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in spec_before.items():
        if isinstance(entries, list):
            assert spec[key][:len(entries)] == entries
        else:
            assert spec[key] == entries


#: a family whose reference loads a module named ``jax`` by name, as a
#: third-party import might: the run's last check has to catch it
LAZY_JAX_FAMILY = '''
import importlib
import sys

from bench.families import transformer
from bench.families.transformer import (attention_layers, chunk_flops,
                                        decode_flops, leaf_specs,
                                        port_fields, sizes_of)

CALLED = []


def forward_logits(*args, **kw):
    sys.path.insert(0, {fake!r})
    try:
        importlib.import_module("jax")
    finally:
        sys.path.remove({fake!r})
    CALLED.append(1)
    return transformer.forward_logits(*args, **kw)
'''


def test_jax_loaded_by_the_reference_stops_the_run(tmp_path):
    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "jax.py").write_text("LOADED = True\n")
    root = tiny_tree(tmp_path / "checkout")
    (root / "bench" / "families" / "lazy_jax.py").write_text(
        LAZY_JAX_FAMILY.format(fake=str(fake)))
    add_config(root, dict(TINY_MOE, name="tiny-lazy", family="lazy_jax"))
    add_cell(root, tiny_cell("tiny-lazy.chat", "tiny-lazy"))
    cell = load_cell("tiny-lazy.chat", root)
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            runner.run_cell(cell, 8, 2.0, False, "cpu", log=lambda s: None)
        assert cell.family.CALLED
    finally:
        sys.modules.pop("jax", None)


def test_families_take_their_reference_from_bench_reference():
    for p in (BENCH_DIR / "families").glob("*.py"):
        if p.stem == "__init__":
            continue
        fam = load_family(p.stem)
        assert fam.forward_logits.__module__.startswith(
            "bench.reference"), p


def test_general_files_name_no_family_and_no_model():
    words = {p.stem for p in (BENCH_DIR / "families").glob("*.py")
             if p.stem != "__init__"}
    for p in (BENCH_DIR / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        words |= {c["name"], c["arch"], c["arch"].split("-")[0]}
    words |= {"transformer", "jamba", "hybrid", "mamba"}
    for name in ("registry", "runner", "compare", "tracing", "weights"):
        code = (BENCH_DIR / "harness" / f"{name}.py").read_text().lower()
        found = sorted(w for w in words if w.lower() in code)
        assert not found, (name, found)
        assert "reference import" not in code, name


def test_every_configuration_names_a_family():
    for p in (BENCH_DIR / "configs").glob("*.json"):
        family = json.loads(p.read_text())["family"]
        assert (BENCH_DIR / "families" / f"{family}.py").is_file(), p
