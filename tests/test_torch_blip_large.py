"""BLIP-large's path in the port, on the CPU at tiny widths whose vision
tower is wider than the text stack (as blip-large's 1024 over 768):

- the loader reads the published ``BlipForQuestionAnswering`` layout
  (``vision_model.*``, ``text_encoder.*``; ``text_decoder.*`` not read,
  and reported), the ``BlipModel`` layout, and an answer head given in
  the checkpoint (linear or MLP, its cross-attention's keys wider than
  its queries as a torch ``MultiheadAttention`` with ``kdim`` holds them);
- BLIPVideoQA against the benchmark's plain f32 reference
  (``port_bench.reference.blip``) on seeded random weights: loss, logits
  and every leaf's gradient, with the head's dropout off and on;
- the model's spans on an eager pass."""

import numpy as np
import pytest
import torch

from sasvqa_torch.core import profiling
from sasvqa_torch.models import convert as cv
from sasvqa_torch.models.blip import BLIPTextConfig, BLIPVisionConfig
from sasvqa_torch.models.presets import load_pretrained_params
from sasvqa_torch.models.video_qa import BLIPVideoQA, ClassifierHeadConfig

from port_bench import weights
from port_bench.reference import blip as ref_blip
from port_bench.reference import common

TEXT = dict(vocab_size=300, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=24)
VISION = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
              num_attention_heads=4, image_size=32, patch_size=16)
LABELS = 7


def _model(classifier="mlp", seed=0):
    tc = BLIPTextConfig(vocab_size=TEXT["vocab_size"], hidden_size=32,
                        intermediate_size=64, num_layers=2, num_heads=4,
                        max_position_embeddings=24,
                        encoder_width=VISION["hidden_size"])
    vc = BLIPVisionConfig(hidden_size=48, intermediate_size=96,
                          num_layers=2, num_heads=4, image_size=32,
                          patch_size=16)
    head = ClassifierHeadConfig(num_labels=LABELS, classifier=classifier,
                                hidden_dropout_prob=0.1)
    return BLIPVideoQA(tc, vc, head,
                       generator=torch.Generator().manual_seed(seed))


def _hf(kind="vqa"):
    """The state dict of a tiny ``transformers`` BlipForQuestionAnswering
    (or BlipModel), every tensor moved off its init (LayerNorms start at
    the port's 1 and 0 too)."""
    from transformers import (BlipConfig, BlipForQuestionAnswering,
                              BlipModel)
    torch.manual_seed(3)
    cfg = BlipConfig(text_config=dict(TEXT, encoder_hidden_size=VISION[
        "hidden_size"]), vision_config=VISION)
    hf = (BlipForQuestionAnswering if kind == "vqa" else BlipModel)(cfg)
    return {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point()
            else v for k, v in hf.state_dict().items()}


def _save(sd, root):
    root.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().clone() for k, v in sd.items()},
               root / "pytorch_model.bin")
    return str(root)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _expected(sd, model):
    """The port's parameters the checkpoint ``sd`` gives, by name."""
    conv = cv.convert_blip_video_qa(
        {k: v.numpy() for k, v in sd.items()},
        model.text_config.num_layers, model.vision_config.num_layers)
    return cv.state_dict_from_flax(conv)


def test_loader_reads_the_published_vqa_layout(tmp_path):
    """Every tower tensor of a BlipForQuestionAnswering loads, none stays
    at its init; the text encoder has no pooler, the answer decoder is
    reported as not read, the head keeps its init."""
    sd = _hf("vqa")
    model = _model()
    init = _params(model)
    report = load_pretrained_params("blip", model, _save(sd, tmp_path))
    assert not report["mismatched"]
    assert report["missing_in_ckpt"] == ["/answer_head",
                                         "/txt_model/pooler"]
    assert report["skipped_in_ckpt"] == sorted(
        k for k in sd if k.startswith("text_decoder."))
    want = _expected(sd, model)
    towers = [n for n in init if n.startswith(("txt_model.", "vis_model."))
              and not n.startswith("txt_model.pooler.")]
    assert sorted(want) == sorted(towers)
    read = {k for k in sd if k.startswith(("vision_model.",
                                           "text_encoder."))}
    assert len(report["loaded"]) == len(read)
    got = _params(model)
    for n in towers:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=0)
        assert not torch.equal(got[n], init[n]), n
    key = "text_encoder.encoder.layer.1.crossattention.self.key.weight"
    assert tuple(sd[key].shape) == (32, 48)
    torch.testing.assert_close(
        got["txt_model.layers_1.crossattention.key.weight"], sd[key])
    for n in init:
        if n.startswith(("answer_head.", "txt_model.pooler.")):
            assert torch.equal(got[n], init[n]), n


def test_loader_still_reads_the_blip_model_layout(tmp_path):
    sd = _hf("model")
    model = _model()
    report = load_pretrained_params("blip", model, _save(sd, tmp_path))
    assert not report["mismatched"] and "skipped_in_ckpt" not in report
    assert report["missing_in_ckpt"] == ["/answer_head"]
    got = _params(model)
    for n, t in _expected(sd, model).items():
        torch.testing.assert_close(got[n], t, rtol=0, atol=0)
    torch.testing.assert_close(got["txt_model.pooler.weight"],
                               sd["text_model.pooler.dense.weight"])


def _torch_head(classifier, d=32, dv=48, seed=5):
    """An answer head in the reference classifier's names from real torch
    modules: the fusion layer's self-attention packed, its
    cross-attention over ``dv``-wide keys (separate q/k/v weights)."""
    torch.manual_seed(seed)
    mods = {"self_attn": torch.nn.MultiheadAttention(d, 8,
                                                     batch_first=True),
            "multihead_attn": torch.nn.MultiheadAttention(
                d, 8, kdim=dv, vdim=dv, batch_first=True),
            "linear1": torch.nn.Linear(d, 4 * d),
            "linear2": torch.nn.Linear(4 * d, d),
            "norm1": torch.nn.LayerNorm(d), "norm2": torch.nn.LayerNorm(d),
            "norm3": torch.nn.LayerNorm(d)}
    sd = {}
    for name, m in mods.items():
        for k, v in m.state_dict().items():
            sd[f"attention.attention.layers.0.{name}.{k}"] = v + 0.01 * \
                torch.randn_like(v)
    width = d
    if classifier == "mlp":
        width = 2 * d
        for k, v in torch.nn.Linear(d, width).state_dict().items():
            sd[f"cls_fc.{k}"] = v
    for k, v in torch.nn.Linear(width, LABELS).state_dict().items():
        sd[f"classifier.{k}"] = v
    return sd, mods


@pytest.mark.parametrize("classifier", ["linear", "mlp"])
def test_loader_reads_a_head_in_the_checkpoint(tmp_path, classifier):
    """A head in the checkpoint loads exactly; the cross-attention of the
    loaded fusion layer is torch's MultiheadAttention with kdim."""
    head, mods = _torch_head(classifier)
    sd = dict(_hf("vqa"), **head)
    model = _model(classifier)
    report = load_pretrained_params("blip", model, _save(sd, tmp_path))
    assert not report["mismatched"]
    assert report["missing_in_ckpt"] == ["/txt_model/pooler"]
    got = _params(model)
    want = _expected(sd, model)
    names = [n for n in got if n.startswith("answer_head.")]
    assert sorted(names) == sorted(n for n in want
                                   if n.startswith("answer_head."))
    for n in names:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=0)
    mha = mods["multihead_attn"]
    mha.load_state_dict({k[len("attention.attention.layers.0."
                               "multihead_attn."):]: v
                         for k, v in head.items() if ".multihead_attn." in k})
    g = torch.Generator().manual_seed(1)
    x, mem = torch.randn(2, 5, 32, generator=g), torch.randn(2, 3, 48,
                                                             generator=g)
    ours = model.answer_head.attention.layers_0.cross_attn(x, kv_states=mem)
    torch.testing.assert_close(ours, mha(x, mem, mem, need_weights=False)[0],
                               rtol=1e-5, atol=1e-6)


def _reference_config(classifier="mlp"):
    return {"vision_config": dict(VISION, num_channels=3,
                                  layer_norm_eps=1e-5),
            "text_config": dict(TEXT, layer_norm_eps=1e-12),
            "answer_head": {"num_labels": LABELS, "classifier": classifier,
                            "cls_hidden_scale": 2,
                            "hidden_dropout_prob": 0.1, "fusion_layers": 1,
                            "fusion_heads": 8, "ffn_scale": 4,
                            "layer_norm_eps": 1e-6}}


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The program and the checkpoint it loaded: seeded weights in the
    published layout with an MLP head, nothing kept from init but the
    unused pooler."""
    c = _reference_config()
    sd = weights.seeded_state_dict(ref_blip.checkpoint_shapes(c), 7, "cpu",
                                   ref_blip.is_layer_norm_weight)
    root = weights.write(str(tmp_path_factory.mktemp("ckpt")), sd)
    model = _model()
    report = load_pretrained_params("blip", model, root)
    assert not report["mismatched"]
    assert report["missing_in_ckpt"] == ["/txt_model/pooler"]
    return c, model, weights.load(root, "cpu")


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    pix = torch.randn((3, 2, 3, 32, 32), generator=g)
    mask = torch.zeros((3, 12), dtype=torch.long)
    for i, n in enumerate((6, 12, 3)):
        mask[i, :n] = 1
    ids = torch.randint(5, TEXT["vocab_size"], (3, 12), generator=g) * mask
    return pix, ids, mask, torch.tensor([2, -100, 6])


@pytest.mark.parametrize("dropout", [False, True], ids=["off", "on"])
def test_program_matches_the_reference(seeded, dropout):
    """Loss, logits and every leaf's gradient of BLIPVideoQA's training
    forward against the plain f32 reference; f32 on the CPU, so only the
    order of sums differs (the program's LayerNorm variance is E[x^2] -
    E[x]^2, its masks add -1e9 where the reference's add -inf)."""
    c, model, W = seeded
    pix, ids, mask, labels = _batch()

    def gen():
        return torch.Generator().manual_seed(11) if dropout else None

    model.train()
    model.zero_grad()
    out = model(ids, mask, pix.permute(0, 1, 3, 4, 2), labels=labels,
                deterministic=not dropout, generator=gen())
    out["loss"].backward()
    P = {k: v.clone().requires_grad_(True) for k, v in W.items()
         if ref_blip.trainable(k)}
    with common.no_tf32():
        z = ref_blip.logits(P, c, pix, ids, mask, gen(), common.Arith())
        valid = labels != -100
        loss = (torch.nn.functional.cross_entropy(
            z, torch.where(valid, labels, 0), reduction="none")
            * valid).sum() / valid.sum()
        loss.backward()
        again = ref_blip.train_loss(P, c, pix, ids, mask, labels, gen(),
                                    common.Arith())
    assert float(again) == float(loss)
    torch.testing.assert_close(out["logits"], z.detach(), rtol=1e-4,
                               atol=1e-5)
    assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-5)
    grads = _expected({k: p.grad for k, p in P.items()}, model)
    # a leaf's own scale, but no finer than a thousandth of the largest
    # (the keys' biases of softmax attention have a gradient of 0 that
    # both sides read as round-off)
    top = max(float(g.abs().max()) for g in grads.values())
    for n, p in model.named_parameters():
        if n.startswith("txt_model.pooler."):
            assert p.grad is None or not p.grad.any(), n
            continue
        scale = max(float(grads[n].abs().max()), 1e-3 * top)
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-3,
                                   atol=1e-4 * scale,
                                   msg=lambda m, n=n: f"{n}: {m}")


def test_dropout_moves_the_head_alone(seeded):
    """The head's dropout draws change the logits; the towers draw
    nothing (BLIP's text dropouts are 0), so the text encoder's output
    is the same with and without a generator."""
    c, model, W = seeded
    pix, ids, mask, _ = _batch(1)
    model.train()
    with torch.no_grad():
        a = model(ids, mask, pix.permute(0, 1, 3, 4, 2))["logits"]
        b = model(ids, mask, pix.permute(0, 1, 3, 4, 2),
                  deterministic=False,
                  generator=torch.Generator().manual_seed(3))["logits"]
        txt = model._encode(ids, mask, pix.permute(0, 1, 3, 4, 2), 1,
                            torch.Generator().manual_seed(3))[0]
        txt0 = model._encode(ids, mask, pix.permute(0, 1, 3, 4, 2), 1,
                             None)[0]
    assert not torch.allclose(a, b)
    assert torch.equal(txt, txt0)


def test_model_spans_on_an_eager_pass(seeded):
    """Under a profiler an eager forward records model.vision, then
    model.text, then model.head, one each, on the caller's thread."""
    _, model, _ = seeded
    pix, ids, mask, labels = _batch(2)
    model.eval()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(ids, mask, pix.permute(0, 1, 3, 4, 2), labels=labels)
    recorded = [s for s in profiling.spans() if s.name.startswith("model.")]
    assert [s.name for s in sorted(recorded, key=lambda s: s.start)] == [
        "model.vision", "model.text", "model.head"]
    assert all(s.end >= s.start for s in recorded)
    vis, txt, head = sorted(recorded, key=lambda s: s.start)
    assert vis.end <= txt.start and txt.end <= head.start
    assert np.unique([s.thread for s in recorded]).size == 1
