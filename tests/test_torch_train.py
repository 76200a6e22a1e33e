"""The port's training path against the JAX reference on the CPU: the
training forward, the loss and its gradients for the dense, MoE, VLM,
RWKV, hybrid and encoder-decoder families; the loss's chunked form; remat; AdamW and the
schedule; the train step; the Mamba scan's two forms; the data packer; the
train launcher; and the counterpart of ``tests/test_system.py``: train with
an injected failure, recover bit for bit, serve the trained weights.

Tolerances: logits within 1e-5 of the largest |logit|; the loss within
1e-5 relative; each gradient leaf within 1e-4 of that leaf's largest
|grad|; parameters after a step within 1e-5 (all fp32)."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FP32, configs, perturb, to_np
from repro.data import pack_documents as jax_pack_documents
from repro.models import build_model as jax_build_model
from repro.models.model_zoo import _xent as jax_xent
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import global_norm as jax_global_norm
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, scale_down
from repro_torch.data import (DataPipeline, SyntheticCorpus, pack_documents,
                              packing_efficiency)
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import grouped_swiglu
from repro_torch.kernels.prefix_scan import prefix_scan
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import build_model
from repro_torch.models.model_zoo import _xent
from repro_torch.models.ssm import _mamba_scan_chunked, mamba_fwd
from repro_torch.models.transformer import _layer
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               global_norm, warmup_cosine)
from repro_torch.params import from_numpy_params
from repro_torch.runtime import SimulatedFailure, TrainSupervisor
from repro_torch.serving import ServingEngine
from repro_torch.train import make_decode_step, make_train_step
from repro_torch.train.step import _loss_and_grads
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

#: family -> (arch, config overrides; the droppy MoE's capacity sheds
#: assignments at this batch); the sequence (20) spans two scan chunks of
#: the scaled-down RWKV (16) with a padded tail, and five of Mamba's (4,
#: the chunk ``models/ssm.py::_scan_chunk`` takes for 20 steps)
FAMILIES = {"dense": ("qwen2-1.5b", {}),
            "moe": ("mixtral-8x22b", {}),
            "moe_droppy": ("mixtral-8x22b", {"moe_dropless": False,
                                             "capacity_factor": 0.5}),
            "vlm": ("internvl2-26b", {}),
            "ssm": ("rwkv6-3b", {}),
            "hybrid": ("jamba-v0.1-52b", {}),
            "encdec": ("seamless-m4t-medium", {})}
SEQ = 20
#: source frames of an encoder-decoder batch
SRC = 12



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread is the fastest, and it keeps the
    test workers running in parallel from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _jax_paths(tree) -> dict:
    """The reference's leaves by checkpoint path (``ckpt._flatten``)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(arch, seed=0, **over):
    """Reference and port models with the same fp32 weights (the
    reference's init, jitted, bridged through numpy)."""
    jcfg, tcfg = configs(arch, **over)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray,
                        jax.jit(jmodel.init)(jax.random.PRNGKey(seed)))
    tree = perturb(tree, np.random.default_rng(seed))
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            build_model(tcfg, "cpu"), from_numpy_params(tree, tcfg, "cpu"))


def _batch(cfg, seed=0, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.vision_embed_dim:
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_embed_dim)
        ).astype(np.float32)
    if cfg.num_encoder_layers:
        batch["src_embeds"] = rng.standard_normal(
            (b, SRC, cfg.audio_embed_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _port_loss_and_grads(model, params, batch):
    """(loss, metrics, {path: grad}) through the train step's own
    ``_loss_and_grads``."""
    metrics, grads = _loss_and_grads(model, params, batch)
    return metrics["loss"], metrics, dict(tree_leaves_with_path(grads))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """Each family's forward, loss and gradients in both packages."""
    arch, over = FAMILIES[request.param]
    jmodel, jparams, tmodel, tparams = _pair(arch, **over)
    jb, tb = _batch(tmodel.cfg)
    jout, ((jloss, jmet), jgrads) = jax.jit(lambda p, b: (
        jmodel.forward(p, b),
        jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)))(jparams, jb)
    with torch.no_grad():
        tout = tmodel.forward(tparams, tb)
    tloss, tmet, tgrads = _port_loss_and_grads(tmodel, tparams, tb)
    return dict(name=request.param, cfg=tmodel.cfg, jout=jout, tout=tout,
                jloss=jloss, jmet=jmet, jgrads=_jax_paths(jgrads),
                tloss=tloss, tmet=tmet, tgrads=tgrads)


def test_forward_matches_reference(family):
    want, got = family["jout"], family["tout"]
    logits = np.asarray(want.logits)
    assert got.logits.shape == logits.shape
    bound = 1e-5 * np.abs(logits).max()
    assert np.abs(to_np(got.logits) - logits).max() <= bound
    if family["cfg"].family == "moe":
        np.testing.assert_array_equal(got.moe_load.numpy(),
                                      np.asarray(want.moe_load))
        # the dropped router mass: per layer, the same assignments summed
        # in another order (fp32)
        np.testing.assert_allclose(to_np(got.moe_dropped),
                                   np.asarray(want.moe_dropped),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(got.moe_aux), float(want.moe_aux),
                                   rtol=1e-6)
        if not family["cfg"].moe_dropless:
            assert (np.asarray(want.moe_dropped) > 0).any()
    elif family["cfg"].family == "hybrid":
        np.testing.assert_allclose(float(got.moe_aux), float(want.moe_aux),
                                   rtol=1e-6)
    else:
        assert got.moe_aux is None and want.moe_aux is None


def test_loss_and_grads_match_reference(family):
    np.testing.assert_allclose(float(family["tloss"]),
                               float(family["jloss"]), rtol=1e-5)
    assert set(family["tmet"]) == set(family["jmet"])
    for k, v in family["jmet"].items():
        np.testing.assert_allclose(float(family["tmet"][k]), float(v),
                                   rtol=1e-5, atol=1e-7)
    tg, jg = family["tgrads"], family["jgrads"]
    assert set(tg) == set(jg)
    for k, want in jg.items():
        err = np.abs(to_np(tg[k]) - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-30), (k, err)


def test_xent_chunked_matches_full():
    """The vocab-chunked logsumexp against the full one (and the
    reference's), with a chunk that does not divide V; gradients too."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 1000)).astype(np.float32) * 4
    labels = rng.integers(0, 1000, (2, 7)).astype(np.int32)
    want = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels), 96))
    grads = []
    for chunk in (0, 96):
        x = torch.from_numpy(logits).requires_grad_()
        loss = _xent(x, torch.from_numpy(labels), chunk)
        loss.backward()
        np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
        grads.append(x.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_remat_gradients_bit_exact(arch):
    """Recomputing each layer (``remat``) changes no gradient bit."""
    cfg = scale_down(get_config(arch)).replace(**FP32)
    _, tb = _batch(cfg)
    grads = []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat), "cpu")
        grads.append(_port_loss_and_grads(model, model.init(0), tb)[2])
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


def _opt_tree(rng):
    return {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32) * 3],
            "c": rng.standard_normal((3, 3)).astype(np.float32)}


def test_adamw_matches_reference():
    """Three updates of a tree with fp32 and bf16 leaves, the first clipped
    (grad norm far above clip_norm), against the reference."""
    rng = np.random.default_rng(4)
    p0 = _opt_tree(rng)
    bf16 = {"c"}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
          if k != "b" else [jnp.asarray(v[0])] for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                    else torch.float32)
          if k != "b" else [torch.from_numpy(v[0])] for k, v in p0.items()}
    jstate, tstate = jax_adamw_init(jp), adamw_init(tp)
    for i, scale in enumerate((1e4, 1.0, 0.3)):
        g = tree_map(lambda x: x * scale, _opt_tree(rng))
        jg = jax.tree.map(jnp.asarray, g)
        tg = tree_map(torch.from_numpy, g)
        jp, jstate, jm = jax_adamw_update(jg, jstate, jp, 1e-2)
        tp, tstate, tm = adamw_update(tg, tstate, tp, 1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        if i == 0:
            assert float(tm["grad_norm"]) > 1e3
    assert int(tstate.step) == int(jstate.step) == 3
    got = {k: to_np(v) for k, v in tree_leaves_with_path(
        {"p": tp, "m": tstate.m, "v": tstate.v})}
    want = _jax_paths({"p": jp, "m": jstate.m, "v": jstate.v})
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert tp["c"].dtype == torch.bfloat16
    assert tstate.m["c"].dtype == torch.float32


def test_global_norm_and_warmup_cosine_equal_reference():
    t = {"a": np.ones((3,), np.float32), "b": np.full((4,), 2, np.float32)}
    assert float(global_norm(tree_map(torch.from_numpy, t))) \
        == float(jax_global_norm(jax.tree.map(jnp.asarray, t)))
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    got = [float(warmup_cosine(s, **kw)) for s in range(0, 120, 3)]
    want = [float(jax_warmup_cosine(s, **kw)) for s in range(0, 120, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0
    assert abs(float(warmup_cosine(10, **kw)) - 3e-3) < 1e-9


def test_train_step_matches_reference():
    """One step of ``make_train_step`` against the reference's jitted step
    on the same fp32 weights and batch (two microbatches): parameters and
    moments within 1e-5.  Adam's first update is lr g / (|g| + eps), so an
    element whose gradient is near eps moves by an amount that fp32
    rounding of the gradient sets: at lr 1e-3 up to 3.7e-5 here (qwen's
    key bias, whose gradient is zero in exact arithmetic, and rows of the
    embedding).  The step is taken at lr 1e-4, where that is 10x smaller."""
    jmodel, jparams, tmodel, tparams = _pair("qwen2-1.5b", seed=1)
    jb, tb = _batch(tmodel.cfg, seed=1, b=4)
    lr = 1e-4
    jp, jopt, jm = jax.jit(jax_make_train_step(jmodel, num_microbatches=2))(
        jparams, jax_adamw_init(jparams), jb, jnp.float32(lr))
    tp, topt, tm = make_train_step(tmodel, num_microbatches=2)(
        tparams, adamw_init(tparams), tb, lr)
    for k in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    want = _jax_paths({"params": jp, "opt": jopt})
    got = {k: to_np(v) for k, v in tree_leaves_with_path(
        {"params": tp, "opt": topt})}
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-5, k


def _bf16_setup(seed=0):
    cfg = scale_down(get_config("qwen2-1.5b"))
    model = build_model(cfg, "cpu")
    return cfg, model, model.init(seed)


def test_grad_accumulation_equivalence():
    """Counterpart of ``tests/test_train.py``: 1 against 4 microbatches in
    the default bf16 config, the reference's tolerances."""
    cfg, model, params = _bf16_setup()
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=2),
                        global_batch=8, seq_len=32)
    batch = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
    out = []
    for n in (1, 4):
        p = tree_map(torch.clone, params)
        p, _, m = make_train_step(model, num_microbatches=n)(
            p, adamw_init(p), batch, 1e-3)
        out.append((p, float(m["loss"])))
    deltas = [float((a.float() - b.float()).abs().max()) for a, b in
              zip(tree_leaves(out[0][0]), tree_leaves(out[1][0]))]
    assert max(deltas) < 0.02
    assert abs(out[0][1] - out[1][1]) < 0.05


def test_loss_decreases():
    """Counterpart of ``tests/test_train.py``: 25 steps at lr 3e-3."""
    cfg, model, params = _bf16_setup()
    opt = adamw_init(params)
    step = make_train_step(model)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=1),
                        global_batch=8, seq_len=64)
    losses = []
    for _ in range(25):
        batch = {k: torch.from_numpy(v)
                 for k, v in pipe.next_batch().items()}
        params, opt, metrics = step(params, opt, batch, 3e-3)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


@pytest.mark.parametrize("t,chunk", [(37, 16), (16, 16), (5, 8)])
def test_mamba_scan_grad_form_same_bits(t, chunk):
    """The scan's autograd form (steps stacked) gives the bits of its
    in-place form, and its gradient flows to the decays, inputs and h0."""
    g = torch.Generator().manual_seed(t)
    a = torch.rand(2, t, 6, 4, generator=g) * 0.5 + 0.5
    b = torch.randn(2, t, 6, 4, generator=g)
    h0 = torch.randn(2, 6, 4, generator=g)
    with torch.no_grad():
        hs, h = _mamba_scan_chunked(a, b, h0, chunk)
    leaves = [x.clone().requires_grad_() for x in (a, b, h0)]
    hs2, h2 = _mamba_scan_chunked(*leaves, chunk)
    assert hs2.grad_fn is not None
    assert torch.equal(hs, hs2.detach()) and torch.equal(h, h2.detach())
    (hs2.sum() + h2.sum()).backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in leaves)


def test_hybrid_prefill_unchanged_by_the_grad_form():
    """A Mamba layer of Jamba through the scan's autograd form gives the
    output and state of the serving form bit for bit, on that layer's own
    weights and inputs; Jamba's prefill (the serving form) still gives the
    reference's greedy token."""
    jmodel, jparams, tmodel, tparams = _pair("jamba-v0.1-52b", seed=2)
    cfg = tmodel.cfg
    jb, tb = _batch(cfg, seed=2, s=37)
    jb, tb = {"tokens": jb["tokens"]}, {"tokens": tb["tokens"]}
    mamba = _layer(tparams["superblocks"], 0)["layers"][1]["mamba"]
    x = torch.randn(2, 37, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        serve = mamba_fwd(mamba, x, cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(), mamba)
    grad_form = mamba_fwd(live, x, cfg)
    assert grad_form[0].grad_fn is not None
    for a, b in zip(tree_leaves(serve), tree_leaves(grad_form)):
        assert torch.equal(a, b.detach())
    with torch.no_grad():
        serve, _ = tmodel.prefill(tparams, tb, 64)
    want, _ = jmodel.prefill(jparams, jb, 64)
    np.testing.assert_array_equal(serve.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


def test_kernel_plain_versions_stay_differentiable():
    """On a CPU tensor each wrapper runs its plain version, which autograd
    differentiates; the refusal applies to the CUDA branch only."""
    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    q, k, v = rnd(1, 8, 4, 16), rnd(1, 8, 2, 16), rnd(1, 8, 2, 16)
    x, wg, wu, wd = rnd(2, 4, 8), rnd(2, 8, 12), rnd(2, 8, 12), rnd(2, 12, 8)
    load = torch.tensor([3, 4], dtype=torch.int32)
    r, kk, vv = rnd(1, 6, 2, 4), rnd(1, 6, 2, 4), rnd(1, 6, 2, 4)
    w = torch.rand(1, 6, 2, 4, generator=g).requires_grad_()
    u, s0, xs = rnd(2, 4), rnd(1, 2, 4, 4), rnd(2, 9)
    outs = [flash_attention(q, k, v), grouped_swiglu(x, wg, wu, wd, load),
            *wkv6(r, kk, vv, w, u, s0), prefix_scan(xs)]
    sum(o.sum() for o in outs).backward()
    for t in (q, k, v, x, wg, wu, wd, r, kk, vv, w, u, s0, xs):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def test_refuse_autograd():
    """The wrappers' CUDA-branch guard: raises only with grad enabled and
    an input that requires grad."""
    plain, live = torch.ones(2), torch.ones(2, requires_grad=True)
    refuse_autograd("k", plain, None)
    with torch.no_grad():
        refuse_autograd("k", live)
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no "
                                           "backward pass"):
        refuse_autograd("k", plain, live)


def test_decode_step_greedy_and_sampled():
    cfg, model, params = _bf16_setup()
    tokens = torch.arange(6, dtype=torch.int32)[None].repeat(2, 1)
    logits, cache = model.prefill(params, {"tokens": tokens}, 16)
    decode = make_decode_step(model, sample=True, temperature=0.7)
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    draws = []
    for seed in (7, 7):
        c = tree_map(torch.clone, cache)
        nxt, _, _ = decode(params, tok, c, 6,
                           torch.Generator().manual_seed(seed))
        draws.append(nxt)
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    nxt, lg, _ = make_decode_step(model)(params, tok, cache, 6)
    assert torch.equal(nxt[:, 0], lg[:, -1].argmax(-1).int())


def test_pack_documents_shards_match_reference():
    lengths = SyntheticCorpus(512, seed=3, mean_doc_len=96).doc_lengths(0, 60)
    for shards in (1, 4):
        rows, shard = pack_documents(lengths, 256, num_shards=shards)
        want_rows, want_shard = jax_pack_documents(lengths, 256,
                                                   num_shards=shards)
        assert rows == want_rows
        np.testing.assert_array_equal(shard, np.asarray(want_shard))
    assert packing_efficiency(rows, 256) > 0.9


def test_train_crash_restore_serve(tmp_path):
    """Counterpart of ``tests/test_system.py``: ten steps with a failure
    injected at step 6 end bit for bit as the clean run; the trained
    weights then serve."""
    cfg, model, params = _bf16_setup()
    opt = adamw_init(params)
    step_fn = make_train_step(model)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=9)

    def make_state():
        return {"params": tree_map(torch.clone, params),
                "opt": tree_map(torch.clone, opt)}

    def run(inject: bool, tag: str):
        pipe = DataPipeline(corpus, global_batch=4, seq_len=32)
        mgr = CheckpointManager(str(tmp_path / tag), keep=2)
        tripped = {"done": False}

        def step(state, i):
            if inject and i == 6 and not tripped["done"]:
                tripped["done"] = True
                raise SimulatedFailure("host lost")
            # deterministic data replay keyed on the global step
            pipe.state.step = i
            batch = {k: torch.from_numpy(v)
                     for k, v in pipe.next_batch().items()}
            p, o, _ = step_fn(state["params"], state["opt"], batch, 1e-3)
            return {"params": p, "opt": o}

        sup = TrainSupervisor(mgr, step, make_state(), ckpt_every=2)
        state, end = sup.run(make_state(), 10)
        assert end == 10 and sup.restarts == int(inject)
        return state

    clean = run(False, "clean")
    faulty = run(True, "faulty")
    for (k, a), b in zip(tree_leaves_with_path(clean),
                         tree_leaves(faulty)):
        assert torch.equal(a, b), k
    eng = ServingEngine(model, clean["params"], max_batch=2, s_max=48)
    req = eng.submit(np.arange(5) % cfg.vocab_size, max_new_tokens=3)
    outs = eng.run_until_drained()
    assert len(outs[req.rid]) == 3
    assert req.state.name == "DONE"


TRAIN = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--smoke-layers", "2", "--smoke-dmodel", "64", "--seq-len", "32",
         "--global-batch", "4"]


def test_launcher_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = subprocess.run(TRAIN + ["--device", "cpu", "--steps", "3",
                                  "--ckpt-dir", ckpt],
                         env=ENV, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "step     2 loss=" in out.stdout and "done" in out.stdout
    again = subprocess.run(TRAIN + ["--device", "cpu", "--steps", "5",
                                    "--ckpt-dir", ckpt],
                           env=ENV, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0, again.stdout + again.stderr
    assert "resumed from step 3" in again.stdout
    assert "step     4 loss=" in again.stdout
    assert "step     0" not in again.stdout


def test_launcher_without_cuda_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(TRAIN + ["--steps", "1"], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr


def test_adamw_state_is_a_namedtuple_of_fp32_moments():
    _, _, params = _bf16_setup()
    state = adamw_init(params)
    assert isinstance(state, AdamWState) and state.step.dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.m))
    assert [m.shape for m in tree_leaves(state.v)] \
        == [p.shape for p in tree_leaves(params)]

