"""The VLM trunk (internvl2-26b, scaled: 8 image tokens of 48 wide) in the
port against the JAX package on bridged weights (fp32): the projector's
init tree, ``lm_prefill`` with ``image_embeds`` (logits and the cache over
``num_image_tokens + S`` positions), greedy decode steps after the image
prefix, the prefix's effect on the logits, the embedded sequence itself
(the tanh GELU), the text-only engine, and the bridge's ``vlm`` tree.

Tolerances: logits 1e-4 and caches 1e-5 absolute (the dense parity
tests'); greedy tokens identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import transformer as jax_transformer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.models import build_model, transformer
from repro_torch.params import from_numpy_params
from repro_torch.serving import ServingEngine as TorchEngine

from _torch_parity import configs, models, to_np
from test_torch_engine import MODES, _serve
from test_torch_engine import _prompts as _engine_prompts

ARCH = "internvl2-26b"
S_MAX = 48
ATOL_LOGITS, ATOL_CACHE = 1e-4, 1e-5


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _inputs(cfg, b=2, s=9, seed=0):
    """Token ids [b, s] and image embeddings [b, num_image_tokens,
    vision_embed_dim] from one numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    img = rng.normal(0, 1, (b, cfg.num_image_tokens,
                            cfg.vision_embed_dim)).astype(np.float32)
    return toks, img


def _batches(toks, img):
    return ({"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(toks),
             "image_embeds": torch.from_numpy(img)})


def test_init_tree_matches_reference():
    """The port's own init has the reference's tree, shapes and types,
    ``vis_proj`` included (fc1: vision width -> d_model, fc2: d_model ->
    d_model)."""
    jmodel, jp, _, _ = models(seed=0, arch=ARCH)
    _, tcfg = configs(ARCH)
    mine = build_model(tcfg, "cpu").init(0)

    def shapes(tree, np_like):
        return jax.tree.map(lambda a: (tuple(np.shape(a)),
                                       np.dtype(np_like(a)).name), tree)
    want = shapes(jp, lambda a: np.asarray(a).dtype)
    got = shapes(mine, lambda t: to_np(t).dtype if t.dtype == torch.float32
                 else t.dtype)
    assert got == want
    assert got["vis_proj"]["fc1"]["w"][0] == (tcfg.vision_embed_dim,
                                              tcfg.d_model)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_with_image_matches_reference(flash):
    jmodel, jp, tmodel, tp = models(seed=1, arch=ARCH, use_flash=flash)
    cfg = tmodel.cfg
    toks, img = _inputs(cfg)
    jb, tb = _batches(toks, img)
    jlog, jc = _jit(jmodel.prefill, 2)(jp, jb, S_MAX)
    tlog, tc = tmodel.prefill(tp, tb, S_MAX)
    np.testing.assert_allclose(to_np(tlog), to_np(jlog), atol=ATOL_LOGITS)
    np.testing.assert_allclose(to_np(tc.k), to_np(jc.k), atol=ATOL_CACHE)
    np.testing.assert_allclose(to_np(tc.v), to_np(jc.v), atol=ATOL_CACHE)
    # the image tokens fill the cache's first num_image_tokens positions
    filled = cfg.num_image_tokens + toks.shape[1]
    assert to_np(tc.k)[:, :, :filled].any(axis=(0, 1, 3, 4)).all()
    assert not to_np(tc.k)[:, :, filled:].any()


@pytest.mark.parametrize("flash", [False, True])
def test_decode_after_image_prefix(flash):
    """Eight greedy decode steps after an image-prefixed prefill, at
    positions past ``num_image_tokens + S``: logits and tokens."""
    jmodel, jp, tmodel, tp = models(seed=2, arch=ARCH, use_flash=flash)
    cfg = tmodel.cfg
    toks, img = _inputs(cfg, seed=3)
    jb, tb = _batches(toks, img)
    jlog, jc = _jit(jmodel.prefill, 2)(jp, jb, S_MAX)
    tlog, tc = tmodel.prefill(tp, tb, S_MAX)
    jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))
    ttok = torch.argmax(tlog[:, -1], dim=-1)
    assert ttok.tolist() == jtok.tolist()
    pos = cfg.num_image_tokens + toks.shape[1]
    for _ in range(8):
        jlog, jc = _jit(jmodel.decode_step)(
            jp, jnp.asarray(jtok[:, None], jnp.int32), jc, jnp.int32(pos))
        tlog, tc = tmodel.decode_step(tp, ttok[:, None], tc, pos)
        np.testing.assert_allclose(to_np(tlog), to_np(jlog),
                                   atol=ATOL_LOGITS)
        jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))
        ttok = torch.argmax(tlog[:, -1], dim=-1)
        assert ttok.tolist() == jtok.tolist()
        pos += 1


def test_image_prefix_changes_the_logits():
    """Other image embeddings, or none, give other logits; the same ones
    give the same bits."""
    _, _, model, params = models(seed=4, arch=ARCH)
    toks, img = _inputs(model.cfg, seed=5)
    _, other = _inputs(model.cfg, seed=6)
    tokens = torch.from_numpy(toks)

    def last(batch):
        return model.prefill(params, batch, S_MAX)[0]
    base = last({"tokens": tokens, "image_embeds": torch.from_numpy(img)})
    again = last({"tokens": tokens, "image_embeds": torch.from_numpy(img)})
    assert torch.equal(base, again)
    for batch in ({"tokens": tokens, "image_embeds": torch.from_numpy(other)},
                  {"tokens": tokens}):
        assert (last(batch) - base).abs().max().item() > 1e-3


def test_image_prefix_embeddings_match_reference():
    """The embedded sequence (projected image tokens, then the token
    embeddings) against the reference's ``_embed_inputs``, within 1e-6.
    The projector's GELU is ``jax.nn.gelu``'s default, the tanh form:
    with the erf form the image rows would be farther off than that."""
    jmodel, jp, model, params = models(seed=4, arch=ARCH)
    toks, img = _inputs(model.cfg, seed=7)
    jb, tb = _batches(toks, img)
    want = to_np(jax_transformer._embed_inputs(jp, jb, jmodel.cfg))
    got = transformer._embed_inputs(params, tb, model.cfg)
    n_img = model.cfg.num_image_tokens
    assert got.shape == (2, n_img + toks.shape[1], model.cfg.d_model)
    np.testing.assert_allclose(to_np(got), want, atol=1e-6, rtol=0)
    vp = params["vis_proj"]
    erf = F.gelu(tb["image_embeds"] @ vp["fc1"]["w"]) @ vp["fc2"]["w"]
    assert np.abs(to_np(erf) - want[:, :n_img]).max() > 1e-5


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged+chunked"])
def test_text_only_engine_matches_reference(mode):
    """The engine serves a VLM text-only, as the reference's does: the
    same greedy tokens and batch metrics in each KV mode."""
    jmodel, jp, tmodel, tp = models(seed=8, arch=ARCH, use_flash=True)
    prompts = _engine_prompts(tmodel.cfg.vocab_size, n=4)
    kw = dict(max_batch=3, s_max=S_MAX, block_size=8, **MODES[mode])
    want, jeng = _serve(JaxEngine(jmodel, jp, **kw), prompts, 1)
    got, teng = _serve(TorchEngine(tmodel, tp, **kw), prompts, 1)
    assert got == want
    assert teng.batcher.metrics == jeng.batcher.metrics


def test_bridge_vlm_tree():
    """The bridge carries ``vis_proj`` leaf by leaf, bit for bit, and
    refuses a tree without it or with a projector of the wrong width."""
    jmodel, jp, _, _ = models(seed=0, arch=ARCH)
    tree = jax.tree.map(np.asarray, jp)
    cfg = configs(ARCH)[1]
    got = from_numpy_params(tree, cfg, "cpu")
    for name in ("fc1", "fc2"):
        assert np.array_equal(got["vis_proj"][name]["w"].numpy(),
                              tree["vis_proj"][name]["w"])
    with pytest.raises(ValueError, match="vis_proj"):
        from_numpy_params({k: v for k, v in tree.items()
                           if k != "vis_proj"}, cfg, "cpu")
    bad = dict(tree, vis_proj={"fc1": {"w": tree["vis_proj"]["fc1"]["w"]
                                       [:, :-1]},
                               "fc2": tree["vis_proj"]["fc2"]})
    with pytest.raises(ValueError, match="vis_proj"):
        from_numpy_params(bad, cfg, "cpu")
