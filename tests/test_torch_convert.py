"""The port's local HF weight loader vs the JAX package's, on the CPU at
tiny widths: tiny ``transformers`` GIT (with temporal embeddings), CLIP and
BLIP models saved by ``save_pretrained`` as safetensors and as
pytorch_model.bin, loaded by both packages onto the same seeded init.
Every leaf must come out bit-equal, the reports equal list for list and
the logits within 1e-5; checkpoints whose vocabulary, position table or
image size differ from the model give the same mismatches.  Also: the
HF-name generators of ``sasvqa_torch.tools.hf_checkpoint`` against the
tiny models' state dicts; the reference's whole finetuned CLIP and BLIP
classifiers (towers, a torch TransformerDecoder fusion layer, a linear
classifier) through both packages' converters; ``AverageMeter``."""

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


# ---- the reference's whole finetuned classifiers --------------------------

# the classifier models the reference checkpoints hold: a linear answer
# classifier over the dec-only fusion layer
CLASSIFIER_CFGS = {
    family: {"model": {"pretrained_model": f"tiny-{family}",
                       "hidden_dropout_prob": 0.0},
             "img_size": 32, "num_labels": 7}
    for family in ("clip", "blip")}
# the reference's tower prefixes: HF CLIPModel / BlipModel key prefix ->
# the key prefix inside CLIPForSeqClassification (keys of no listed
# prefix, the unused projections, are left out)
TOWER_PREFIXES = {
    "clip": {"text_model.": "vlm.txt_model.text_model.",
             "vision_model.": "vlm.vis_model.vision_model.",
             "visual_projection.": "vlm.vis_model.visual_projection."},
    "blip": {"text_model.": "vlm.txt_model.",
             "vision_model.": "vlm.vis_model."}}
CONVERTERS = {"clip": ("convert_clip_classifier", hfc.hf_clip_shapes,
                       tpresets._clip_configs),
              "blip": ("convert_blip_classifier", hfc.hf_blip_shapes,
                       tpresets._blip_configs)}


def _torch_decoder(d, seed, eps=1e-6):
    """The reference's fusion layer: a 1-layer torch TransformerDecoder
    (8 heads, d_ff 4d, post-LN, relu), dropout off, LayerNorm epsilon
    ``eps``."""
    torch.manual_seed(seed)
    return torch.nn.TransformerDecoder(torch.nn.TransformerDecoderLayer(
        d, 8, 4 * d, dropout=0.0, batch_first=True, layer_norm_eps=eps),
        1).eval()


def _reference_classifier_sd(family, wrapped, seed=0):
    """A seeded state dict in the reference classifier's key names:
    towers from hf_checkpoint's shape functions, the fusion layer from a
    real torch TransformerDecoder, a linear classifier; under
    ``VLModel.`` when ``wrapped``."""
    _, shapes_of, configs = CONVERTERS[family]
    tower = hfc.seeded_hf_state_dict(shapes_of(*configs("tiny")), seed)
    sd = {}
    for key, val in tower.items():
        for src, dst in TOWER_PREFIXES[family].items():
            if key.startswith(src):
                sd[dst + key[len(src):]] = val
    d = configs("tiny")[0].hidden_size
    for key, val in _torch_decoder(d, seed).state_dict().items():
        sd[f"attention.attention.{key}"] = val
    torch.manual_seed(seed + 1)
    for key, val in torch.nn.Linear(d, 7).state_dict().items():
        sd[f"classifier.{key}"] = val
    return {f"VLModel.{k}" if wrapped else k: v for k, v in sd.items()}


def _leaves(tree, path=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{path}/{key}")
        else:
            yield f"{path}/{key}", val


@pytest.fixture(scope="module")
def classifier_models():
    """family -> (JAX model, init params, jitted logits) of the linear
    classifier."""
    out = {}
    for family, cfg in CLASSIFIER_CFGS.items():
        _, jm = jpresets.build_model(ConfigDict(cfg), dtype=jnp.float32)
        ids, mask, px = _inputs()
        params = jax.jit(jm.init)(jax.random.key(5), ids, mask, px)
        logits = jax.jit(lambda p, i, m, x, jm=jm: jm.apply(p, i, m, x)[
            "logits"])
        out[family] = (jm, params, logits)
    return out


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("family", ["clip", "blip"])
def test_classifier_converter_matches_jax(family, wrapped,
                                          classifier_models):
    """convert_{clip,blip}_classifier on a reference-layout dict: the tree
    equals the JAX converter's leaf by leaf; merged, it loads every leaf
    but mc_head's (the JAX test's rule) with no mismatch, and the port's
    logits equal JAX's merged model's within 1e-5 in f32."""
    from sasvqa_torch.models import convert as tconvert
    name = CONVERTERS[family][0]
    sd = _reference_classifier_sd(family, wrapped)
    tc, vc = CONVERTERS[family][2]("tiny")
    want = getattr(jconvert, name)(sd, tc.num_layers, vc.num_layers)
    got = getattr(tconvert, name)(sd, tc.num_layers, vc.num_layers)
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert got_leaves.keys() == want_leaves.keys()
    for path, val in want_leaves.items():
        assert np.array_equal(got_leaves[path], np.asarray(val)), path
    assert "/answer_head/attention/layers_0/cross_attn/k_proj/kernel" in \
        got_leaves

    jm, params, jlogits = classifier_models[family]
    jmerged, jreport = jconvert.merge_pretrained(params["params"], want)
    _, tm = tpresets.build_model(CLASSIFIER_CFGS[family], device="cpu")
    load_flax_params(tm, params)
    report = merge_pretrained(tm, got)
    for r in (report, jreport):
        assert not r["mismatched"], r["mismatched"]
        assert all(p.startswith("/mc_head") for p in r["missing_in_ckpt"]
                   ), r["missing_in_ckpt"]
    assert report["loaded"] == sorted(
        p for p in jreport["loaded"] if not p.startswith("/mc_head"))
    ids, mask, px = _inputs(seed=2)
    with torch.no_grad():
        ours = tm(to_torch(ids, torch.long), to_torch(mask),
                  to_torch(px))["logits"]
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jlogits({"params": jmerged}, ids, mask, px)),
        atol=1e-5, rtol=1e-5)


def test_fusion_layer_matches_torch_decoder():
    """The port's fusion layer, loaded by the converter from a torch
    TransformerDecoder's state dict, gives that decoder's output within
    1e-5 (f32; both with LayerNorm epsilon 1e-6, the port's, and a padded
    target)."""
    from sasvqa_torch.models import convert as tconvert
    from sasvqa_torch.models.fusion import TransformerDecoderLayer
    d = 32
    ref = _torch_decoder(d, seed=3)
    sd = {f"attention.attention.{k}": v
          for k, v in ref.state_dict().items()}
    layer = TransformerDecoderLayer(d, d, 8, dropout_rate=0.0).eval()
    report = merge_pretrained(layer, tconvert._torch_decoder_layer(
        sd, "attention.attention.layers.0"))
    assert not report["mismatched"] and not report["missing_in_ckpt"]
    rng = np.random.default_rng(3)
    tgt = to_torch(rng.standard_normal((2, 6, d), dtype=np.float32))
    mem = to_torch(rng.standard_normal((2, 4, d), dtype=np.float32))
    valid = torch.ones(2, 6, dtype=torch.int32)
    valid[1, 4:] = 0
    with torch.no_grad():
        want = ref(tgt, mem, tgt_key_padding_mask=valid == 0)
        got = layer(tgt, mem, tgt_key_padding_mask=valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_average_meter_matches_jax():
    from sasvqa_tpu.core.logging import AverageMeter as JMeter

    from sasvqa_torch.core.logging import AverageMeter
    ours, ref = AverageMeter(), JMeter()
    for val, n in ((2.0, 1), (0.5, 3), (-1.25, 2), (4.0, 0)):
        ours.update(val, n)
        ref.update(val, n)
        assert vars(ours) == vars(ref)
    ours.reset()
    assert vars(ours) == {"val": 0.0, "avg": 0.0, "sum": 0.0, "count": 0}
