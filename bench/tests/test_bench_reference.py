"""The plain reference against the port at a tiny size on the CPU, in fp32:
the same weights (made by the benchmark, in the port's layout) give the
same logits.  The test imports both; the reference imports neither."""
import subprocess
import sys

import pytest
import torch

from bench.families import transformer
from bench.families.transformer import forward_logits, sizes_of
from bench.harness.runner import port_config
from bench.harness.weights import make_weights
from bench.tests._tiny import ROOT, TINY_DENSE, TINY_MOE

def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


CONFIGS = {"moe": TINY_MOE, "dense": TINY_DENSE,
           "moe_window": dict(TINY_MOE, sliding_window=16)}


def _tree_shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_shapes(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("name", ["moe", "dense"])
def test_weights_have_the_port_layout(name):
    from repro_torch.models import build_model
    config = CONFIGS[name]
    model = build_model(port_config(transformer, config), "cpu")
    ours = make_weights(transformer, sizes_of(config), 3, "cpu")
    assert _tree_shapes(ours) == _tree_shapes(model.init(3))


def test_weights_follow_the_seed():
    s = sizes_of(TINY_DENSE)
    a = make_weights(transformer, s, 5, "cpu")
    b = make_weights(transformer, s, 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    c = make_weights(transformer, s, 6, "cpu")
    assert not torch.equal(a["lm_head"]["w"], c["lm_head"]["w"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_equals_the_port_in_fp32(name):
    from repro_torch.models import build_model
    from repro_torch.models.transformer import lm_forward
    config = dict(CONFIGS[name], torch_dtype="float32")
    cfg = port_config(transformer, config)
    sizes = sizes_of(config)
    w = make_weights(transformer, sizes, 11, "cpu")
    build_model(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, 512, (n,), generator=g) for n in (40, 23)]
    ref = forward_logits(w, sizes, seqs, [0, 5])
    for seq, r, got in zip(seqs, [0, 5], ref):
        with torch.no_grad():
            port = lm_forward(w, {"tokens": seq[None]}, cfg).logits[0, r:]
        scale = port.abs().max()
        assert (port - got).abs().max() < 2e-5 * scale


def test_reference_imports_torch_only():
    code = ("import sys; sys.path.insert(0, %r); import bench.reference; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
