"""Vision-tower remat and the GIT presets of the port vs the JAX package,
in f32 on the CPU: a tiny patch-14 tower and a tiny GIT with remat give
the outputs and gradients of the same models without remat and of the
JAX remat models; build_model honours the dropout and remat keys as the
JAX build_model does."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.models import clip as jclip
from sasvqa_tpu.models import git as jgit
from sasvqa_tpu.models import presets as jpresets

from sasvqa_torch.models import clip as tclip
from sasvqa_torch.models import git as tgit
from sasvqa_torch.models import presets as tpresets
from sasvqa_torch.models.convert import state_dict_from_flax

from _torch_parity import (load_flax_params, numpy_tree, port_git_config,
                           to_torch)

# the training parity tests' f32 tolerance (tests/test_torch_train.py)
ATOL, RTOL = 2e-5, 2e-4

# ViT-L/14's patch size on 28x28 frames: 4 patches + CLS a frame
TINY_L14 = jclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                  num_layers=2, num_heads=4, image_size=28,
                                  patch_size=14, projection_dim=32)


def _port_vision(remat):
    return tclip.CLIPVisionEncoder(
        tclip.CLIPVisionConfig(**dataclasses.asdict(TINY_L14)),
        post_ln_all_tokens=True, with_projection=False, remat=remat)


def _pixels(n=3, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 28, 28, 3)).astype(np.float32)


def _tower_out_and_grads(model, px):
    x = to_torch(px).requires_grad_(True)
    hidden, _, _ = model(x)
    (hidden ** 2).mean().backward()
    return (hidden.detach().numpy(), x.grad.numpy(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def test_vision_tower_remat_matches_no_remat_and_jax():
    jm = jclip.CLIPVisionEncoder(TINY_L14, post_ln_all_tokens=True,
                                 with_projection=False, remat=True)
    px = _pixels()
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(px))

    def jloss(p, x):
        hidden, _, _ = jm.apply(p, x)
        return (hidden ** 2).mean(), hidden

    (_, jhidden), (jgrads, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(px))
    ref = state_dict_from_flax(numpy_tree(jgrads))

    outs = {}
    for remat in (True, False):
        model = load_flax_params(_port_vision(remat), params).train()
        outs[remat] = _tower_out_and_grads(model, px)
    (h_r, dx_r, g_r), (h_n, dx_n, g_n) = outs[True], outs[False]
    # recompute in the backward repeats the forward's arithmetic exactly
    np.testing.assert_array_equal(h_r, h_n)
    np.testing.assert_array_equal(dx_r, dx_n)
    for name in g_n:
        np.testing.assert_array_equal(g_r[name], g_n[name], err_msg=name)
    np.testing.assert_allclose(h_r, np.asarray(jhidden), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dx_r, np.asarray(jdx), atol=ATOL, rtol=RTOL)
    assert set(g_r) == set(ref)
    for name, val in ref.items():
        np.testing.assert_allclose(g_r[name], val.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def _tiny_git(**drop):
    return dataclasses.replace(jpresets._git_config("tiny"), vision=TINY_L14,
                               **drop)


def test_git_remat_loss_and_grads_match_no_remat_and_jax():
    """The training forward (hidden dropout 0.1 off via deterministic=True,
    so both frameworks run the same function) with remat on: loss and
    every gradient equal the port without remat and jax.grad of the JAX
    remat model."""
    cfg = _tiny_git()
    jm = jgit.GITForCausalLM(cfg, remat=True)
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(1), ids, ids,
                              jnp.zeros((1, 1, 28, 28, 3)))
    rng = np.random.default_rng(2)
    b, t, l = 2, 3, 8
    tok = rng.integers(5, cfg.vocab_size, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, 5:] = 0
    labels = np.where(mask == 1, tok, -100).astype(np.int32)
    labels[:, :2] = -100
    px = rng.normal(size=(b, t, 28, 28, 3)).astype(np.float32)

    def loss_fn(p):
        return jm.apply(p, tok, mask, px, labels=labels)["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    ref = state_dict_from_flax(numpy_tree(jgrads))
    res = {}
    for remat in (True, False):
        tm = load_flax_params(tgit.GITForCausalLM(port_git_config(cfg),
                                                  remat=remat), params)
        assert tm.image_encoder.remat is remat
        loss = tm.train()(to_torch(tok, torch.long), to_torch(mask),
                          to_torch(px), labels=to_torch(labels, torch.long)
                          )["loss"]
        loss.backward()
        res[remat] = (loss.item(), {n: p.grad.numpy()
                                    for n, p in tm.named_parameters()})
    assert res[True][0] == res[False][0]
    for name, g in res[False][1].items():
        np.testing.assert_array_equal(res[True][1][name], g, err_msg=name)
    np.testing.assert_allclose(res[True][0], float(jloss), atol=ATOL,
                               rtol=RTOL)
    for name, val in ref.items():
        np.testing.assert_allclose(res[True][1][name], val.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_named_remat_policy_raises():
    with pytest.raises(NotImplementedError, match="dots_saveable"):
        tclip.CLIPVisionEncoder(
            tclip.CLIPVisionConfig(**dataclasses.asdict(TINY_L14)),
            remat=True, remat_policy="dots_saveable")
    cfg = {"model": {"pretrained_model": "tiny-git",
                     "remat_policy": "dots_with_no_batch_dims_saveable"},
           "remat": True}
    with pytest.raises(NotImplementedError, match="remat_policy"):
        tpresets.build_model(cfg, device="cpu")


PRESET_CONFIGS = [
    {"model": {"pretrained_model": "tiny-git"}},
    {"model": {"pretrained_model": "tiny-git", "hidden_dropout_prob": 0.0,
               "attention_probs_dropout_prob": 0.0}},
    {"model": {"pretrained_model": "tiny-git", "hidden_dropout_prob": 0.2,
               "attention_probs_dropout_prob": 0.2, "remat": True}},
    {"model": {"pretrained_model": "tiny-git", "hidden_dropout_prob": 0.0,
               "attention_probs_dropout_prob": 0.2, "vocab_size": 300},
     "remat": True, "img_size": 64},
    {"model": {"pretrained_model": "tiny-git", "remat": False,
               "attention_probs_dropout_prob": 0.0}, "remat": True},
]


@pytest.mark.parametrize("cfg", PRESET_CONFIGS)
def test_build_model_honours_dropout_and_remat_keys(cfg):
    """The port's GITConfig and remat flag equal the JAX build_model's
    for the same config (the JAX package's precedence: model block, then
    top level)."""
    jfamily, jm = jpresets.build_model(ConfigDict(cfg))
    family, tm = tpresets.build_model(cfg, device="cpu")
    assert family == jfamily == "git"
    assert tm.config == port_git_config(jm.config)
    assert tm.image_encoder.remat == jm.remat
    assert jm.remat_policy is None
