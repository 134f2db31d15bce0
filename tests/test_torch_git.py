"""Port GIT model vs the JAX package's, on the same carried-over weights,
in f32: vision tower, scoring forward, prompt_fill, decode_step and
greedy tokens, over the dense route and the git-flash route."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.models import clip as jclip
from sasvqa_tpu.models import git as jgit
from sasvqa_tpu.models.presets import TINY_VISION
from sasvqa_tpu.ops import git_flash as jgf

from sasvqa_torch.models import clip as tclip
from sasvqa_torch.models import git as tgit

from _torch_parity import load_flax_params, port_git_config, to_torch

ATOL, RTOL = 1e-4, 1e-4

# tiny-git (models/presets.py) and the small 65-token-per-frame config of
# tests/test_git_flash.py::test_model_parity_flash_vs_dense
TINY = jgit.GITConfig(vocab_size=512, hidden_size=32, num_layers=2,
                      num_heads=4, intermediate_size=64,
                      max_position_embeddings=128, vision=TINY_VISION)
SMALL = jgit.GITConfig(
    vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, max_position_embeddings=64,
    vision=jclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                  num_layers=1, num_heads=4, image_size=64,
                                  patch_size=8))
ROUTES = {"dense": (TINY, False), "git_flash": (SMALL, True)}


@pytest.fixture(autouse=True)
def interpret_mode():
    jgf.set_interpret_mode(True)
    yield
    jgf.set_interpret_mode(False)


def _pair(route):
    """(jax model, params, port model) on the same weights."""
    cfg, flash = ROUTES[route]
    jm = jgit.GITForCausalLM(cfg, flash=flash)
    img = cfg.vision.image_size
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), ids, ids,
                              jnp.zeros((1, 1, img, img, 3)))
    tm = load_flax_params(tgit.GITForCausalLM(port_git_config(cfg),
                                              flash=flash), params)
    return jm, params, tm.eval()


def _batch(cfg, b=3, t=2, l=10, seed=0):
    rng = np.random.default_rng(seed)
    img = cfg.vision.image_size
    ids = rng.integers(5, cfg.vocab_size, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    px = rng.normal(size=(b, t, img, img, 3)).astype(np.float32)
    return ids, mask, px


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("post_ln_all,proj", [(True, False), (False, True)])
def test_vision_tower_matches(post_ln_all, proj):
    cfg = TINY_VISION
    jm = jclip.CLIPVisionEncoder(cfg, post_ln_all_tokens=post_ln_all,
                                 with_projection=proj)
    px = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    params = jm.init(jax.random.key(1), jnp.asarray(px))
    tm = load_flax_params(tclip.CLIPVisionEncoder(
        tclip.CLIPVisionConfig(**vars(cfg)), post_ln_all_tokens=post_ln_all,
        with_projection=proj), params)
    jout = jm.apply(params, jnp.asarray(px))
    with torch.no_grad():
        tout = tm(to_torch(px))
    for j, t in zip(jout, tout):
        if j is None:
            assert t is None
        else:
            _close(t.numpy(), j)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_logits_and_loss_match(route):
    jm, params, tm = _pair(route)
    ids, mask, px = _batch(jm.config)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    jout = jm.apply(params, ids, mask, px)
    jloss = jm.apply(params, ids, mask, px, labels=labels)
    with torch.no_grad():
        tout = tm(to_torch(ids), to_torch(mask), to_torch(px))
        tloss = tm(to_torch(ids), to_torch(mask), to_torch(px),
                   labels=to_torch(labels))
    _close(tout["logits"].numpy(), jout["logits"])
    _close(tloss["logits_text"].numpy(), jloss["logits_text"])
    _close(tloss["loss"].numpy(), jloss["loss"])


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("pixels", ["f32", "u8"])
def test_prompt_fill_and_decode_steps_match(route, pixels):
    jm, params, tm = _pair(route)
    ids, _, px = _batch(jm.config, seed=2)
    if pixels == "u8":
        from sasvqa_tpu.core.pixels import quantize_u8
        px = quantize_u8(px)
    plen = np.array([10, 6, 0], np.int32)
    max_text_len = 14
    jlast, jcache = jm.apply(params, ids, plen, px, max_text_len,
                             method=jm.prompt_fill)
    with torch.no_grad():
        tlast, tcache = tm.prompt_fill(to_torch(ids, torch.long),
                                       to_torch(plen, torch.long),
                                       to_torch(px), max_text_len)
    _close(tlast.numpy(), jlast)
    for part in ("img_kv", "txt_kv"):
        for (jk, jv), (tk, tv) in zip(jcache[part], tcache[part]):
            _close(tk.numpy(), jk)
            _close(tv.numpy(), jv)

    tok = np.array([7, 9, 11], np.int32)
    for _ in range(2):
        jlogits, jcache = jm.apply(params, jnp.asarray(tok), jcache,
                                   method=jm.decode_step)
        with torch.no_grad():
            tlogits, tcache = tm.decode_step(to_torch(tok, torch.long),
                                             tcache)
        _close(tlogits.numpy(), jlogits)
        for (jk, jv), (tk, tv) in zip(jcache["txt_kv"], tcache["txt_kv"]):
            _close(tk.numpy(), jk)
            _close(tv.numpy(), jv)
        np.testing.assert_array_equal(tcache["cur_len"].numpy(),
                                      np.asarray(jcache["cur_len"]))
        tok = np.asarray(jlogits).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_identical(route):
    jm, params, tm = _pair(route)
    ids, _, px = _batch(jm.config, b=4, l=8, seed=3)
    plen = np.array([8, 3, 0, 5], np.int32)
    for max_text_len in (8, 12):
        jtok = np.asarray(jgit.greedy_generate(jm, params, ids, plen, px,
                                               max_text_len=max_text_len))
        ttok = tgit.greedy_generate(tm, ids, plen, px,
                                    max_text_len=max_text_len, device="cpu")
        np.testing.assert_array_equal(ttok.numpy(), jtok)


def test_cache_write_past_buffer_keeps_old_values():
    """A row whose position ran past the text buffer writes nothing (the
    JAX one-hot blend is all zeros there)."""
    buf = torch.arange(2 * 1 * 3 * 2, dtype=torch.float32).view(2, 1, 3, 2)
    new = torch.full((2, 1, 1, 2), -1.0)
    cur = torch.tensor([1, 3])
    before = buf.clone()
    tgit._cache_write(buf, new, torch.arange(2), cur.clamp(max=2), cur < 3)
    assert torch.equal(buf[0, :, 1], new[0, :, 0])
    assert torch.equal(buf[1], before[1])


@pytest.mark.parametrize("vision_width,layers", [(48, 3), (16, 1)])
def test_state_dict_carries_over_any_config(vision_width, layers):
    """Vision and text widths that differ, other depths: every Flax leaf
    maps onto a port parameter (strict load) and the logits agree."""
    cfg = jgit.GITConfig(
        vocab_size=40, hidden_size=24, num_layers=layers, num_heads=3,
        intermediate_size=40, max_position_embeddings=32,
        vision=jclip.CLIPVisionConfig(
            hidden_size=vision_width, intermediate_size=2 * vision_width,
            num_layers=layers, num_heads=4, image_size=16, patch_size=8))
    jm = jgit.GITForCausalLM(cfg)
    ids, mask, px = _batch(cfg, b=3, t=1, l=6, seed=5)
    params = jm.init(jax.random.key(2), ids, mask, px)
    tm = load_flax_params(tgit.GITForCausalLM(port_git_config(cfg)),
                          params).eval()
    with torch.no_grad():
        out = tm(to_torch(ids), to_torch(mask), to_torch(px))["logits"]
    _close(out.numpy(), jm.apply(params, ids, mask, px)["logits"])
