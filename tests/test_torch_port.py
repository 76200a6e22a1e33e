"""The port as a package: it imports neither JAX nor ``repro``, its copied
modules equal their references, its entry points run on CUDA unless asked
for the CPU, the launcher's equality gate passes on the CPU, and the weight
bridge carries the reference's trees."""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, scale_down
from repro_torch.models import build_model
from repro_torch.params import from_numpy_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--requests", "4", "--max-new-tokens", "4", "--s-max", "64",
         "--check-paged-equality"]


#: modules that must be among those scanned (the MoE slice's, the RWKV
#: slice's with the last two kernels, and speculative decoding's)
REQUIRED = ("repro_torch.serving.speculative",
            "repro_torch.core.device.moe_balance", "repro_torch.models.moe",
            "repro_torch.kernels._build", "repro_torch.kernels.moe_gmm",
            "repro_torch.kernels.moe_gmm.ops",
            "repro_torch.kernels.moe_gmm.ref",
            "repro_torch.kernels.moe_gmm.build",
            "repro_torch.configs.rwkv6_3b", "repro_torch.models.ssm",
            "repro_torch.models.rwkv_lm") + tuple(
    f"repro_torch.kernels.{k}{m}" for k in ("wkv6", "prefix_scan")
    for m in ("", ".ops", ".ref", ".build"))


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_hygiene_scans_cover_the_moe_slice():
    assert set(REQUIRED) <= set(_modules())


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


COPY_HEADER = "# Copied from src/repro/{}; only the imports may differ.\n"
COPIES = sorted(p for p in PKG.rglob("*.py")
                if p.read_text().startswith("# Copied from "))


def _without_imports(text: str) -> str:
    """``text`` without its top-level import statements (whole lines)."""
    lines = text.splitlines(keepends=True)
    for node in reversed(ast.parse(text).body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            del lines[node.lineno - 1:node.end_lineno]
    return "".join(lines)


def test_copies_are_found():
    names = {str(p.relative_to(PKG)) for p in COPIES}
    assert {"core/strategy.py", "core/task.py", "core/task_storage.py",
            "core/device/request_scheduler.py", "serving/paged_kv.py",
            "configs/base.py"} <= names


@pytest.mark.parametrize("path", COPIES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_copy_equals_its_reference(path):
    """A module headed "Copied from" is its reference, byte for byte, apart
    from that header and its import lines."""
    rel = path.relative_to(PKG).as_posix()
    text = path.read_text()
    header = COPY_HEADER.format(rel)
    assert text.startswith(header)
    ref = (ROOT / "src" / "repro" / rel).read_text()
    assert _without_imports(text[len(header):]) == _without_imports(ref)


#: the strategy half of ``serving/speculative.py``: a copy of the
#: reference's, byte for byte
SPEC_COPIED = ("SPEC_METRIC_KEYS", "_VERIFY_CLASS", "_DRAFT_CLASS",
               "SPEC_KEY_ARITY", "_assert_spec_key_compat", "_spec_seq",
               "accept_longest_prefix", "SpecStrategy", "DraftStrategy",
               "VerifyStrategy", "_AdaptiveK", "_SlotState")


def _span(text: str, first: str, last: str) -> str:
    """The source lines from top-level definition ``first`` (with the
    comments just above it) through the end of ``last``."""
    def names(node):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            return {t.id for t in targets if isinstance(t, ast.Name)}
        return {getattr(node, "name", None)}
    body = ast.parse(text).body
    start = next(n for n in body if first in names(n))
    end = next(n for n in body if last in names(n))
    lines = text.splitlines(keepends=True)
    lo = start.lineno - 1
    while lo > 0 and lines[lo - 1].startswith("#"):
        lo -= 1
    return "".join(lines[lo:end.end_lineno])


def test_speculative_strategy_half_is_a_copy():
    port = (PKG / "serving" / "speculative.py").read_text()
    ref = (ROOT / "src" / "repro" / "serving" / "speculative.py").read_text()
    half = _span(port, SPEC_COPIED[0], SPEC_COPIED[-1])
    assert half == _span(ref, SPEC_COPIED[0], SPEC_COPIED[-1])
    tree = ast.parse(half)
    defined = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            defined |= {t.id for t in node.targets}
        elif hasattr(node, "name"):
            defined.add(node.name)
    assert defined == set(SPEC_COPIED)


def test_launcher_equality_gate_on_cpu():
    out = subprocess.run(SERVE + ["--device", "cpu"], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: paged decode == contiguous decode" in out.stdout


def test_launcher_equality_gate_on_cpu_moe():
    """Scaled mixtral-8x22b (4 experts, window 64) through all four modes."""
    out = subprocess.run(SERVE + ["--device", "cpu", "--arch",
                                  "mixtral-8x22b"], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: paged decode == contiguous decode" in out.stdout
    assert "token-exact: True" in out.stdout


def test_launcher_equality_gate_on_cpu_rwkv():
    """Scaled rwkv6-3b: no paged path, so the gate runs the contiguous
    engine, skips the paged modes and exits 0, as the reference does."""
    out = subprocess.run(SERVE + ["--device", "cpu", "--arch", "rwkv6-3b"],
                         env=ENV, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "contiguous: 16 tokens" in out.stdout
    for mode in ("paged", "paged+chunked", "paged+cache"):
        assert f"{mode}: family 'ssm' has no paged path — skip" in out.stdout


def test_launcher_spec_gate_on_cpu():
    """``--spec-draft self`` adds the ``paged+spec`` mode, whose tokens must
    equal the contiguous engine's."""
    out = subprocess.run(SERVE + ["--device", "cpu", "--spec-draft",
                                  "self"], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "paged+spec: 16 tokens" in out.stdout
    assert "OK: speculative decode == contiguous decode" in out.stdout


def test_launcher_spec_draft_vocab_mismatch():
    """rwkv6-3b's vocab (65536) is not qwen2-1.5b's: exit 2 before any
    engine is built."""
    out = subprocess.run(SERVE + ["--device", "cpu", "--spec-draft",
                                  "rwkv6-3b"], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "vocab 65536 != target 'qwen2-1.5b' vocab 151936" in out.stderr


def test_launcher_without_cuda_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(SERVE, env=ENV, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("flag", [["--replicas", "2"],
                                  ["--chaos", "kill-one"], ["--autoscale"],
                                  ["--arch", "jamba-v0.1-52b"]])
def test_launcher_refuses_what_is_not_ported(flag):
    out = subprocess.run(SERVE + ["--device", "cpu"] + flag, env=ENV,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2
    assert "not yet ported" in out.stderr


def test_build_model_defaults_to_cuda():
    cfg = scale_down(get_config("qwen2-1.5b"))
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(cfg.replace(family="hybrid"), "cpu")


def _ref_tree(arch="qwen2-1.5b", **over):
    jcfg = jax_scale_down(jax_get_config(arch)).replace(**over)
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    return scale_down(get_config(arch)).replace(**over), tree


def test_bridge_bf16_leaves_bit_exact():
    cfg, tree = _ref_tree()
    leaf = tree["blocks"]["attn"]["wq"]["w"]
    assert leaf.dtype.name == "bfloat16"
    params = from_numpy_params(tree, cfg, "cpu")
    got = params["blocks"]["attn"]["wq"]["w"]
    assert got.dtype == torch.bfloat16 and got.shape == leaf.shape
    assert np.array_equal(got.view(torch.int16).numpy(),
                          leaf.view(np.uint16).view(np.int16))
    as_f32 = from_numpy_params(tree, cfg, "cpu", torch.float32)
    assert as_f32["ln_f"]["scale"].dtype == torch.float32


def test_bridge_stacked_layers_biases_and_tied_embedding():
    cfg, tree = _ref_tree(dtype="float32", param_dtype="float32")
    params = from_numpy_params(tree, cfg, "cpu")
    assert "lm_head" not in params and cfg.tie_embeddings
    for name in ("wq", "wk", "wv"):
        b = params["blocks"]["attn"][name]["b"]
        assert b.shape[0] == cfg.num_layers
    np.testing.assert_array_equal(params["blocks"]["mlp"]["down"]["w"],
                                  tree["blocks"]["mlp"]["down"]["w"])
    untied, tree2 = _ref_tree(dtype="float32", param_dtype="float32",
                              tie_embeddings=False)
    assert "lm_head" in from_numpy_params(tree2, untied, "cpu")
    with pytest.raises(ValueError, match="needs"):
        from_numpy_params(tree2, cfg, "cpu")
    short = cfg.replace(num_layers=cfg.num_layers + 1)
    with pytest.raises(ValueError, match="layers"):
        from_numpy_params(tree, short, "cpu")


def test_bridge_moe_tree():
    """Stacked [L, E, ...] expert leaves bit-exact in bf16; the router
    stays fp32, also under a ``dtype`` cast."""
    cfg, tree = _ref_tree("mixtral-8x22b")
    moe = tree["blocks"]["moe"]
    assert "mlp" not in tree["blocks"]
    params = from_numpy_params(tree, cfg, "cpu")
    got = params["blocks"]["moe"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.resolved_moe_d_ff
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        assert got[name].shape == (cfg.num_layers,) + shape
        assert got[name].dtype == torch.bfloat16
        assert np.array_equal(got[name].view(torch.int16).numpy(),
                              moe[name].view(np.uint16).view(np.int16))
    router = got["router"]["w"]
    assert router.dtype == torch.float32
    assert router.shape == (cfg.num_layers, d, e)
    np.testing.assert_array_equal(router.numpy(), moe["router"]["w"])
    cast = from_numpy_params(tree, cfg, "cpu", torch.bfloat16)
    assert cast["blocks"]["moe"]["router"]["w"].dtype == torch.float32
    assert cast["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_bridge_rwkv_tree():
    """The ssm tree: stacked [L, ...] leaves bit-exact in bf16; the decay
    bias ``w0`` and bonus ``u`` stay fp32, also under a ``dtype`` cast."""
    cfg, tree = _ref_tree("rwkv6-3b")
    assert set(tree) == {"embed", "blocks", "ln_f", "lm_head"}
    params = from_numpy_params(tree, cfg, "cpu")
    tm = params["blocks"]["tm"]
    h, n = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    assert tm["u"].shape == (cfg.num_layers, h, n)
    assert tm["w0"].shape == (cfg.num_layers, cfg.d_model)
    wr = tree["blocks"]["tm"]["wr"]["w"]
    assert wr.dtype.name == "bfloat16"
    assert np.array_equal(tm["wr"]["w"].view(torch.int16).numpy(),
                          wr.view(np.uint16).view(np.int16))
    cast = from_numpy_params(tree, cfg, "cpu", torch.bfloat16)
    for name in ("u", "w0"):
        assert cast["blocks"]["tm"][name].dtype == torch.float32
        np.testing.assert_array_equal(cast["blocks"]["tm"][name].numpy(),
                                      tree["blocks"]["tm"][name])
    assert cast["blocks"]["tm"]["maa"].dtype == torch.bfloat16
    assert cast["blocks"]["tm"]["ln_x"]["bias"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs"):
        from_numpy_params({k: v for k, v in tree.items() if k != "lm_head"},
                          cfg, "cpu")
