"""The encoder-decoder (seamless-m4t-medium, scaled down: 2 encoder and 2
decoder layers, d_model 64, 4 heads of 16 with 4 kv heads) in the port
against the JAX package on bridged weights: the init tree, the training
forward with and without ``audio_proj`` and the one-hot embedding, the
loss and its gradients, ``encdec_prefill`` (logits, self K/V, cross K/V)
at ``s_max`` above and below the prompt, greedy decode with flash off and
on (the reference's kernel in interpret mode, the port's plain version on
the CPU), the scalar-only decode position, the encoder's causal chunked
route at 8192 source frames, the step functions, the weight bridge and
checkpoints, the one-hot ``embed`` and ``launch/input_specs``.

Tolerances (fp32 unless a test says otherwise): logits within 1e-5 of the
largest |logit|; caches within 1e-5 absolute; gradients within 1e-4 of
each leaf's largest |grad|; the loss within 1e-5 relative; greedy tokens,
bridged leaves, checkpoints, one-hot rows and specs exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.launch import input_specs as jax_specs
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.layers import embed as jax_embed
from repro.train import make_decode_step as jax_make_decode_step
from repro.train import make_prefill_step as jax_make_prefill_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import input_specs
from repro_torch.models import build_model, encdec
from repro_torch.models.layers import embed
from repro_torch.optim import adamw_init
from repro_torch.params import from_numpy_params
from repro_torch.train import (make_decode_step, make_prefill_step,
                               make_train_step)
from repro_torch.train.step import _loss_and_grads
from repro_torch.tree import tree_leaves_with_path, tree_map

from _torch_parity import configs, perturb, to_np
from test_torch_checkpoint import _bits
from test_torch_port import _ref_tree

ARCH = "seamless-m4t-medium"
B, S_SRC, S_TGT = 2, 12, 7
LOGIT_REL, ATOL_CACHE, GRAD_REL = 1e-5, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread is the fastest, and it keeps the
    test workers running in parallel from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=0, layers=2, **over):
    """Reference and port models with the same fp32 weights (the
    reference's init, its constant leaves perturbed, bridged through
    numpy)."""
    jcfg, tcfg = configs(ARCH, layers, **over)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray,
                        jax.jit(jmodel.init)(jax.random.PRNGKey(seed)))
    tree = perturb(tree, np.random.default_rng(seed))
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            build_model(tcfg, "cpu"), from_numpy_params(tree, tcfg, "cpu"))


def _inputs(cfg, b=B, s_src=S_SRC, s=S_TGT, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, s_src, cfg.audio_embed_dim)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    np_batch = {"src_embeds": src, "tokens": toks, "labels": labels}
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(to_np(got) - want).max()
    assert err <= LOGIT_REL * np.abs(want).max(), err


def test_init_tree_matches_reference():
    """The port's own init has the reference's tree, shapes and types, with
    ``audio_proj`` only where the source width differs from d_model; its
    linear weights are He-normal (std 1/sqrt(fan_in) within 10 %)."""
    for over in ({}, {"audio_embed_dim": 48}):
        jcfg, tcfg = configs(ARCH, **over)
        ref = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
        want = {"/".join(str(getattr(k, "key", k)) for k in kp):
                (tuple(v.shape), str(v.dtype))
                for kp, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
        mine = build_model(tcfg, "cpu").init(0)
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
               for k, v in tree_leaves_with_path(mine)}
        assert got == want
        assert ("audio_proj" in mine) == bool(over)
    w = mine["dec_blocks"]["cross_attn"]["wq"]["w"]
    assert abs(w.std().item() * 64 ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("audio", [None, 48])
@pytest.mark.parametrize("onehot", [False, True])
def test_forward_matches_reference(audio, onehot):
    over = {"onehot_embed": onehot}
    if audio:
        over["audio_embed_dim"] = audio
    jmodel, jp, tmodel, tp = _models(**over)
    assert ("audio_proj" in tp) == bool(audio)
    jb, tb = _inputs(tmodel.cfg)
    want = jax.jit(jmodel.forward)(jp, jb).logits
    with torch.no_grad():
        got = tmodel.forward(tp, tb).logits
    _close_logits(got, want)


def test_loss_and_grads_with_audio_proj_and_onehot():
    """Gradients reach ``audio_proj`` and the table through the one-hot
    product, as ``jax.value_and_grad`` gives them."""
    jmodel, jp, tmodel, tp = _models(audio_embed_dim=48, onehot_embed=True)
    jb, tb = _inputs(tmodel.cfg, seed=1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jp, jb)
    metrics, grads = _loss_and_grads(tmodel, tp, tb)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    want = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    got = dict(tree_leaves_with_path(grads))
    assert set(got) == set(want)
    assert np.abs(want["audio_proj/w"]).max() > 0
    for k, w in want.items():
        err = np.abs(to_np(got[k]) - w).max()
        assert err <= GRAD_REL * max(np.abs(w).max(), 1e-30), (k, err)


@pytest.mark.parametrize("s_max", [16, 4])
def test_prefill_matches_reference(s_max):
    """Logits, every layer's self K/V (the prompt's last min(s, s_max)
    positions at offset 0, zeros after) and cross K/V [L, B, S_src, kvH,
    hd]."""
    jmodel, jp, tmodel, tp = _models()
    jb, tb = _inputs(tmodel.cfg)
    del jb["labels"], tb["labels"]
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(jp, jb, s_max)
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, tb, s_max)
    _close_logits(tl, jl)
    assert isinstance(tc, encdec.EncDecCache)
    pairs = ((tc.self_kv.k, jc.self_kv.k), (tc.self_kv.v, jc.self_kv.v),
             (tc.cross_k, jc.cross_k), (tc.cross_v, jc.cross_v))
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(to_np(got), np.asarray(want),
                                   rtol=0, atol=ATOL_CACHE)
    assert tc.self_kv.k.shape[2] == s_max
    assert tc.cross_k.shape[2] == S_SRC


def _jax_greedy(jmodel, jp, jb, s_max, steps):
    prefill = jax.jit(jax_make_prefill_step(jmodel, s_max))
    decode = jax.jit(jax_make_decode_step(jmodel))
    logits, cache = prefill(jp, jb)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, all_logits = [np.asarray(tok)], []
    pos = jb["tokens"].shape[1]
    for i in range(steps):
        tok, logits, cache = decode(jp, tok, cache, jnp.int32(pos + i))
        toks.append(np.asarray(tok))
        all_logits.append(np.asarray(logits))
    return np.concatenate(toks, 1), all_logits


def _port_greedy(tmodel, tp, tb, s_max, steps):
    logits, cache = make_prefill_step(tmodel, s_max)(tp, tb)
    decode = make_decode_step(tmodel)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].int()
    toks, all_logits = [tok], []
    pos = tb["tokens"].shape[1]
    for i in range(steps):
        tok, logits, cache = decode(tp, tok, cache, pos + i)
        toks.append(tok)
        all_logits.append(logits)
    return torch.cat(toks, 1).numpy(), all_logits


@pytest.mark.parametrize("use_flash", [False, True])
def test_greedy_decode_matches_reference(use_flash):
    """8 greedy decode steps through ``make_prefill_step`` and
    ``make_decode_step`` at a scalar position: the tokens are the
    reference's, every step's logits within 1e-5 of the largest |logit|.
    With flash on, the reference runs its Pallas kernel in interpret mode
    and the port the kernel's plain version."""
    jmodel, jp, tmodel, tp = _models(use_flash=use_flash)
    jb, tb = _inputs(tmodel.cfg, seed=2)
    for d in (jb, tb):
        del d["labels"]
    want, jlog = _jax_greedy(jmodel, jp, jb, 16, 8)
    got, tlog = _port_greedy(tmodel, tp, tb, 16, 8)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(tlog, jlog):
        _close_logits(g, w)


def test_decode_refuses_a_position_per_row():
    """The reference reshapes ``pos`` to (1, 1), so a [B] position with
    B > 1 fails there; the port refuses it with an error."""
    jmodel, jp, tmodel, tp = _models()
    jb, tb = _inputs(tmodel.cfg)
    _, jc = jmodel.prefill(jp, jb, 16)
    with torch.no_grad():
        _, tc = tmodel.prefill(tp, tb, 16)
    tok = np.zeros((B, 1), np.int32)
    with pytest.raises(TypeError):
        jmodel.decode_step(jp, jnp.asarray(tok), jc,
                           jnp.asarray([S_TGT, S_TGT + 1]))
    with pytest.raises(ValueError, match="one position for the batch"):
        tmodel.decode_step(tp, torch.from_numpy(tok), tc,
                           torch.tensor([S_TGT, S_TGT + 1]))


def test_encoder_at_8192_frames_is_causal_in_both():
    """At S_src = 8192 (a multiple of the chunks) ``attention_fwd`` takes
    the chunked route, which ignores the encoder's all-true mask and runs
    causal, in both packages.  One layer and one head of 64 (the route does
    not depend on the heads); batch row 1 is row 0 with its last frame
    changed.  Outputs agree within 1e-5 of their largest |value|, and row
    1 differs from row 0 at the last position only."""
    jmodel, jp, tmodel, tp = _models(layers=1, num_heads=1, num_kv_heads=1,
                                     head_dim=64)
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    src = rng.standard_normal((1, 8192, cfg.audio_embed_dim)).astype(
        np.float32)
    src = np.concatenate([src, src])
    src[1, -1] += 1.0
    want = np.asarray(jax.jit(lambda p, x: jax_encdec._encode(
        p, x, jmodel.cfg))(jp, jnp.asarray(src)))
    with torch.no_grad():
        got = encdec._encode(tp, torch.from_numpy(src), cfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for out in (got, want):
        np.testing.assert_array_equal(out[0, :-1], out[1, :-1])
        assert not np.array_equal(out[0, -1], out[1, -1])


def test_train_step_splits_src_embeds_into_microbatches():
    """``make_train_step`` cuts ``src_embeds`` along the batch like the
    other keys: 1 and 2 microbatches give the same loss and gradient norm
    (1e-6 relative: fp32 sums in another order)."""
    _, _, tmodel, tp = _models()
    _, tb = _inputs(tmodel.cfg, b=4, seed=4)
    outs = []
    for n in (1, 2):
        params = tree_map(torch.clone, tp)
        _, _, m = make_train_step(tmodel, num_microbatches=n)(
            params, adamw_init(params), tb, 1e-3)
        outs.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)


def test_bridge_bf16_bit_exact_and_refusals():
    """Every bf16 leaf (``audio_proj`` included) bridges bit for bit; a
    tree with a key too many, a key missing, or a stack of the wrong depth
    (either stack) is refused."""
    cfg, tree = _ref_tree(ARCH, audio_embed_dim=48)
    got = from_numpy_params(tree, cfg, "cpu")
    want = {"/".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    seen = dict(tree_leaves_with_path(got))
    assert set(seen) == set(want)
    for k, leaf in seen.items():
        assert leaf.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(_bits(leaf), _bits(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="needs"):
        from_numpy_params({**tree, "extra": tree["ln_f"]}, cfg, "cpu")
    with pytest.raises(ValueError, match="needs"):
        from_numpy_params({k: v for k, v in tree.items()
                           if k != "audio_proj"}, cfg, "cpu")
    for stack, n in (("enc_blocks", cfg.num_encoder_layers),
                     ("dec_blocks", cfg.num_layers)):
        cut = {**tree, stack: jax.tree.map(lambda a: a[:1], tree[stack])}
        with pytest.raises(ValueError, match=f"{stack}/.*!= {n}"):
            from_numpy_params(cut, cfg, "cpu")


def test_checkpoints_cross_both_ways(tmp_path):
    """The reference's bf16 encdec parameters saved as its ``.npz``
    restore in the port bit for bit, and the port's restore in the
    reference."""
    cfg, tree = _ref_tree(ARCH)
    jax_save(str(tmp_path / "ref"), 3, {"params": tree})
    template = {"params": build_model(cfg, "cpu").init(0)}
    got, manifest = restore_checkpoint(str(tmp_path / "ref"), template)
    assert manifest["step"] == 3
    want = {"params/" + "/".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for k, leaf in tree_leaves_with_path(got):
        np.testing.assert_array_equal(_bits(leaf), _bits(want[k]), err_msg=k)
    mine = build_model(cfg, "cpu").init(5)
    save_checkpoint(str(tmp_path / "port"), 4, {"params": mine})
    back, manifest = jax_restore(str(tmp_path / "port"), {"params": tree})
    assert manifest["step"] == 4
    seen = dict(tree_leaves_with_path({"params": mine}))
    for kp, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        k = "/".join(str(getattr(p, "key", p)) for p in kp)
        np.testing.assert_array_equal(_bits(leaf), _bits(seen[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_embed_equals_gather_and_reference(dtype):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 5)).astype(np.int32)
    tt = {"table": torch.from_numpy(table).to(getattr(torch, dtype))}
    jt = {"table": jnp.asarray(table).astype(getattr(jnp, dtype))}
    got = embed(tt, torch.from_numpy(toks), onehot=True)
    assert got.dtype == tt["table"].dtype
    assert torch.equal(got, embed(tt, torch.from_numpy(toks)))
    want = jax_embed(jt, jnp.asarray(toks), onehot=True)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))


def _spec(x):
    return tuple(x.shape), str(x.dtype).split(".")[-1]


def test_input_specs_match_reference():
    """Every config x cell: the same keys, shapes and dtypes (``meta``
    tensors for ``ShapeDtypeStruct``s), and the same applicability and
    microbatch count."""
    assert set(list_configs()) == set(jax_list_configs())
    assert [dataclasses.astuple(c) for c in input_specs.SHAPES] == \
        [dataclasses.astuple(c) for c in jax_specs.SHAPES]
    for name in list_configs():
        tcfg, jcfg = get_config(name), jax_get_config(name)
        for tcell, jcell in zip(input_specs.SHAPES, jax_specs.SHAPES):
            got = input_specs.input_specs(tcfg, tcell)
            want = jax_specs.input_specs(jcfg, jcell)
            assert {k: _spec(v) for k, v in got.items()} == \
                {k: _spec(v) for k, v in want.items()}, (name, tcell.name)
            assert all(v.device.type == "meta" for v in got.values())
            assert input_specs.cell_is_applicable(tcfg, tcell) == \
                jax_specs.cell_is_applicable(jcfg, jcell)
            assert input_specs.train_microbatches(tcfg, tcell) == \
                jax_specs.train_microbatches(jcfg, jcell)
    cell = input_specs.shape_by_name("train_4k")
    batch = input_specs.input_specs(get_config(ARCH), cell)
    assert batch["src_embeds"].shape == (256, 2048, 1024)
    assert batch["tokens"].shape == batch["labels"].shape == (256, 2048)
    with pytest.raises(KeyError):
        input_specs.shape_by_name("nope")
