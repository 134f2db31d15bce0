"""The port's local HF weight loader vs the JAX package's, on the CPU at
tiny widths: tiny ``transformers`` GIT (with temporal embeddings), CLIP and
BLIP models saved by ``save_pretrained`` as safetensors and as
pytorch_model.bin, loaded by both packages onto the same seeded init.
Every leaf must come out bit-equal, the reports equal list for list and
the logits within 1e-5; checkpoints whose vocabulary, position table or
image size differ from the model give the same mismatches.  Also: the
HF-name generators of ``sasvqa_torch.tools.hf_checkpoint`` against the
tiny models' state dicts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.models import convert as jconvert
from sasvqa_tpu.models import presets as jpresets

from sasvqa_torch.models import presets as tpresets
from sasvqa_torch.models.convert import merge_pretrained, state_dict_from_flax

from sasvqa_torch.tools import hf_checkpoint as hfc
from _torch_parity import (TINY_GIT, frames, hf_tiny_blip, hf_tiny_clip,
                           hf_tiny_git, load_flax_params, numpy_tree,
                           save_hf, to_torch)

CFGS = {
    "git": TINY_GIT,
    "clip": {"model": {"pretrained_model": "tiny-clip",
                       "hidden_dropout_prob": 0.0},
             "img_size": 32, "num_labels": 7, "classifier": "mlp"},
    "blip": {"model": {"pretrained_model": "tiny-blip",
                       "hidden_dropout_prob": 0.0},
             "img_size": 32, "num_labels": 7, "classifier": "mlp"},
}
# checkpoint -> (family, HF model); the *_mismatch checkpoints differ from
# the model in the GIT vocabulary and position table, the CLIP text
# position table and the BLIP image size (its vision position table)
CHECKPOINTS = {
    "git": ("git", lambda: hf_tiny_git(num_frames=2)),
    "clip": ("clip", hf_tiny_clip),
    "blip": ("blip", hf_tiny_blip),
    "git_mismatch": ("git", lambda: hf_tiny_git(
        num_frames=3, vocab_size=300, max_position_embeddings=64)),
    "clip_mismatch": ("clip", lambda: hf_tiny_clip(
        max_position_embeddings=16)),
    "blip_mismatch": ("blip", lambda: hf_tiny_blip(image_size=64)),
}


def _inputs(seed=0, b=2, l=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 300, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, 5:] = 0
    px = np.stack([frames(seed + i, 2, 32) for i in range(b)])
    return ids, mask, px


@pytest.fixture(scope="module")
def jax_models():
    """family -> (JAX model, its init params, jitted logits)."""
    out = {}
    for family, cfg in CFGS.items():
        _, jm = jpresets.build_model(ConfigDict(cfg), dtype=jnp.float32)
        ids, mask, px = _inputs()
        params = jax.jit(jm.init)(jax.random.key(3), ids, mask, px)
        logits = jax.jit(lambda p, i, m, x, jm=jm: jm.apply(p, i, m, x)[
            "logits"])
        out[family] = (jm, params, logits)
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """checkpoint name -> {format: directory}."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for name, (_, make) in CHECKPOINTS.items():
        model = make()
        out[name] = {fmt: save_hf(model, root / f"{name}_{fmt}", fmt)
                     for fmt in ("safetensors", "bin")}
    return out


def _jax_load(monkeypatch, family, jm, params, path):
    """The JAX loader's merged params and its merge report."""
    reports = []
    real = jconvert.merge_pretrained

    def capture(init, converted):
        merged, report = real(init, converted)
        reports.append(report)
        return merged, report

    monkeypatch.setattr(jconvert, "merge_pretrained", capture)
    loaded = jpresets.load_pretrained_params(family, jm, params, path)
    assert len(reports) == 1
    return loaded, reports[0]


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_loader_matches_jax(name, fmt, saved, jax_models, monkeypatch):
    """Both loaders on the same checkpoint and init: bit-equal leaves and
    equal reports (paths, order, granularity, mismatch lines); logits
    within 1e-5, once a family (the matching safetensors checkpoint:
    bit-equal leaves give the same logits in every other case)."""
    family = CHECKPOINTS[name][0]
    jm, params, jlogits = jax_models[family]
    path = saved[name][fmt]
    jloaded, jreport = _jax_load(monkeypatch, family, jm, params, path)
    fam, tm = tpresets.build_model(CFGS[family], device="cpu")
    assert fam == family
    load_flax_params(tm, params)
    report = tpresets.load_pretrained_params(family, tm, path)
    assert report == jreport
    assert report["loaded"]
    assert bool(report["mismatched"]) == name.endswith("_mismatch")
    ref = state_dict_from_flax(numpy_tree(jloaded))
    got = tm.state_dict()
    assert set(got) == set(ref)
    for key, val in ref.items():
        assert torch.equal(got[key], val), key
    if fmt != "safetensors" or name != family:
        return
    ids, mask, px = _inputs(seed=1)
    with torch.no_grad():
        ours = tm(to_torch(ids, torch.long), to_torch(mask),
                  to_torch(px))["logits"]
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jlogits(jloaded, ids, mask, px)),
                               atol=1e-5, rtol=1e-5)


def test_report_granularity_and_kept_leaves(saved, jax_models):
    """A classifier checkpoint carries no answer head: the report names
    ``/answer_head`` once and the head keeps its init; a mismatched leaf
    keeps its init and is reported in the Flax layout."""
    _, params, _ = jax_models["clip"]
    _, tm = tpresets.build_model(CFGS["clip"], device="cpu")
    load_flax_params(tm, params)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    report = tpresets.load_pretrained_params(
        "clip", tm, saved["clip_mismatch"]["bin"])
    assert report["missing_in_ckpt"] == ["/answer_head"]
    assert report["mismatched"] == [
        "/txt_model/position_embedding/embedding: ckpt (16, 32) vs model "
        "(32, 32)"]
    after = tm.state_dict()
    for key, val in before.items():
        if key.startswith("answer_head.") or \
                key == "txt_model.position_embedding.weight":
            assert torch.equal(after[key], val), key
    sd = tpresets._load_torch_state_dict(saved["clip_mismatch"]["bin"])
    np.testing.assert_array_equal(
        after["txt_model.token_embedding.weight"].numpy(),
        sd["text_model.embeddings.token_embedding.weight"])
    np.testing.assert_array_equal(
        after["vis_model.layers_1.mlp.fc1.weight"].numpy(),
        sd["vision_model.encoder.layers.1.mlp.fc1.weight"])
    # a kernel is compared and reported (in, out), as the JAX tree holds it
    report = merge_pretrained(tm, {"answer_head": {"classifier": {
        "kernel": np.zeros((7, 32), np.float32),
        "bias": np.zeros((7,), np.float32)}}})
    assert report["mismatched"] == [
        "/answer_head/classifier/kernel: ckpt (7, 32) vs model (64, 7)"]
    assert report["loaded"] == ["/answer_head/classifier/bias"]


def test_checkpoint_file_or_directory(saved):
    """A directory prefers model.safetensors over pytorch_model.bin; a
    file path is read as it is."""
    import os
    import shutil
    d = saved["clip"]["bin"]
    sd = tpresets._load_torch_state_dict(d)
    same = tpresets._load_torch_state_dict(
        os.path.join(d, "pytorch_model.bin"))
    assert sd.keys() == same.keys()
    for key in sd:
        np.testing.assert_array_equal(sd[key], same[key])
    both = os.path.join(os.path.dirname(d), "clip_both")
    shutil.copytree(d, both)
    shutil.copy(os.path.join(saved["clip_mismatch"]["safetensors"],
                             "model.safetensors"), both)
    pos = "text_model.embeddings.position_embedding.weight"
    assert tpresets._load_torch_state_dict(both)[pos].shape == (16, 32)


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_hf_name_generators_match_transformers():
    """tools.hf_checkpoint writes checkpoints in HF's key names without
    transformers (the card's installation has none); at 2 layers its
    names and shapes equal the tiny HF CLIP, GIT and BLIP state dicts."""
    tc, vc = tpresets._clip_configs("tiny")
    assert hfc.hf_clip_shapes(tc, vc) == _shapes(hf_tiny_clip())
    gc = tpresets._git_config("tiny")
    assert hfc.hf_git_shapes(gc, num_frames=2) == \
        _shapes(hf_tiny_git(num_frames=2))
    btc, bvc = tpresets._blip_configs("tiny")
    assert hfc.hf_blip_shapes(btc, bvc) == _shapes(hf_tiny_blip())
    sd = hfc.seeded_hf_state_dict(hfc.hf_clip_shapes(tc, vc),
                                         seed=0)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        hfc.hf_clip_shapes(tc, vc)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in sd.values())
