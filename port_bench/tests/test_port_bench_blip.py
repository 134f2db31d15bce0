"""The BLIP cell's harness at tiny sizes on the CPU: a sound run is
correct; a broken timed path and the float8 control are not, and the
control rounds in both passes; the plain reference against the
program's CPU path on the same checkpoint; the configuration, the
traffic's task config and the answer list agree; the family's leaf map
covers the program; the flash readers' arithmetic."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from port_bench import harness, run, weights
from port_bench.families import blip as fam
from port_bench.reference import blip as ref_blip
from port_bench.reference import common
from port_bench.tests import tiny

SEED = 4_294_967_311          # past 32 bits, as a run's seed may be

TINY_BLIP = {
    "vocab_size": 2048,
    "text_config": {"vocab_size": 2048, "hidden_size": 32,
                    "encoder_hidden_size": 32, "intermediate_size": 64,
                    "num_hidden_layers": 2, "num_attention_heads": 4,
                    "max_position_embeddings": 64},
    "vision_config": {"hidden_size": 32, "intermediate_size": 64,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "image_size": 32, "patch_size": 16},
}


def tiny_blip_config():
    c = tiny._read("configs", "blip_large.json")
    for group in ("text_config", "vision_config"):
        c[group] = dict(c[group], **TINY_BLIP[group])
    c["vocab_size"] = TINY_BLIP["vocab_size"]
    c["program_model"] = "tiny-blip"
    return c


def _cell():
    cell = tiny.tiny_cell("blipl_msvd_train", "msvd_mdf4_train")
    cell.config = tiny_blip_config()
    return cell


def _execute(cell, fault=None, trace_on=False):
    return run.execute(cell, SEED, 0.5, trace_on, device="cpu",
                       fault=fault)


def test_sound_run_is_correct():
    out = _execute(_cell())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_broken_timed_path_is_not_correct(fault):
    out = _execute(_cell(), fault=fault)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    from port_bench.drivers import train
    cell = _cell()
    out = train.run(cell, SEED, 0.2, False, device="cpu",
                    calibrate=("control_fp8",))
    judged = harness.judge(out["controls"]["control_fp8"], cell.limits)
    assert not harness.verdict(judged), judged


def test_float8_control_rounds_both_passes():
    """The control's products read float8 operands in the backward too:
    a linear's input gradient is round(dy) @ round(w), where
    ``Arith(True)`` passes dy through unrounded; a held state is rounded
    in both passes."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(6, 16, generator=g, requires_grad=True)
    w = torch.randn(8, 16, generator=g)
    dy = torch.randn(6, 8, generator=g)
    rq = common.fake_fp8
    for ar, want in ((ref_blip.Float8Products(), rq(dy) @ rq(w)),
                     (common.Arith(True), dy @ rq(w))):
        x.grad = None
        y = ar.linear(x, w)
        torch.testing.assert_close(y, rq(x) @ rq(w).T)
        y.backward(dy)
        torch.testing.assert_close(x.grad, want)
    x.grad = None
    ref_blip.Float8Products().matmul(x, w.T).backward(dy)
    torch.testing.assert_close(x.grad, rq(dy) @ rq(w))
    assert not torch.allclose(x.grad, dy @ rq(w))
    # a held hidden state: float8 in both passes under the control, as it
    # is under the f32 arithmetic
    x.grad = None
    y = ref_blip._hold(ref_blip.Float8Products(), x)
    torch.testing.assert_close(y, rq(x))
    y.backward(dy[:, :1].expand(6, 16).contiguous())
    torch.testing.assert_close(x.grad, rq(dy[:, :1].expand(6, 16)))
    assert ref_blip._hold(common.Arith(), x) is x


def test_configuration_traffic_and_answer_list_agree():
    """The head the reference builds is the head the task config asks the
    program for, and both read one answer list."""
    c = tiny._read("configs", "blip_large.json")
    t = tiny._read("traffic", "msvd_mdf4_train.json")["task_config"]
    h = c["answer_head"]
    assert t["model"]["pretrained_model"] == c["program_model"]
    assert t["model"]["num_labels"] == h["num_labels"]
    assert t["model"]["hidden_dropout_prob"] == h["hidden_dropout_prob"]
    assert (t["classifier"], t["cls_hidden_scale"]) == (
        h["classifier"], h["cls_hidden_scale"])
    assert t.get("max_txt_len", 20) == h["max_txt_len"]
    assert t.get("attn_type", "dec-only") == h["attn_type"]
    assert t["ans2label_path"] == f"port_bench/{h['ans2label']}"
    labels = fam.ans2label(c)
    assert sorted(labels.values()) == list(range(h["num_labels"]))
    assert t["img_size"] == c["vision_config"]["image_size"]
    assert c["vocab_size"] == c["text_config"]["vocab_size"]


@pytest.fixture(scope="module")
def tiny_blip(tmp_path_factory):
    from sasvqa_torch.models.presets import (build_model,
                                             load_pretrained_params)
    c = tiny_blip_config()
    root = str(tmp_path_factory.mktemp("ckpt"))
    sd = weights.seeded_state_dict(ref_blip.checkpoint_shapes(c), 3, "cpu",
                                   ref_blip.is_layer_norm_weight)
    weights.write(root, sd)
    h = c["answer_head"]
    cfg = {"model": {"pretrained_model": "tiny-blip",
                     "vocab_size": c["vocab_size"],
                     "hidden_dropout_prob": h["hidden_dropout_prob"]},
           "num_labels": h["num_labels"], "classifier": h["classifier"],
           "cls_hidden_scale": h["cls_hidden_scale"]}
    family, model = build_model(cfg, dtype=torch.float32, device="cpu")
    report = load_pretrained_params(family, model, root)
    assert not report["mismatched"]
    assert report["missing_in_ckpt"] == ["/txt_model/pooler"]
    assert report["skipped_in_ckpt"] == ["text_decoder.cls.predictions.bias"]
    return c, model, weights.load(root, "cpu")


def test_leaf_map_covers_every_trainable_key(tiny_blip):
    c, model, W = tiny_blip
    names = [n for n, _ in model.named_parameters()]
    norms = fam.leaf_norms(dict(model.named_parameters()), names)
    want = {k for k in W if ref_blip.trainable(k)}
    assert set(norms) == want
    for k in want:
        assert norms[k] == pytest.approx(float(W[k].double().norm()),
                                         rel=1e-6), k


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "train"])
def test_reference_matches_the_program(tiny_blip, dropout):
    c, model, W = tiny_blip
    g = torch.Generator().manual_seed(0)
    img = c["vision_config"]["image_size"]
    pix = torch.randn((3, 2, 3, img, img), generator=g)
    ids = torch.randint(110, c["vocab_size"], (3, 20), generator=g)
    mask = torch.zeros((3, 20), dtype=torch.long)
    for i, n in enumerate((9, 20, 5)):
        mask[i, :n] = 1
    ids = ids * mask
    labels = torch.tensor([4, -100, 999])
    model.train()
    model.zero_grad()
    out = model(ids, mask, pix.permute(0, 1, 3, 4, 2), labels=labels,
                deterministic=not dropout,
                generator=torch.Generator().manual_seed(11)
                if dropout else None)
    out["loss"].backward()
    P = {k: v.clone().requires_grad_(True) for k, v in W.items()
         if ref_blip.trainable(k)}
    with common.no_tf32():
        loss = ref_blip.train_loss(
            P, c, pix, ids, mask, labels,
            torch.Generator().manual_seed(11) if dropout else None,
            common.Arith())
        loss.backward()
    assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-5)
    names = [n for n, _ in model.named_parameters()]
    ours = fam.leaf_norms({n: p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for n, p in model.named_parameters()}, names)
    theirs = {k: float(p.grad.double().norm()) for k, p in P.items()}
    med = float(np.median(list(theirs.values())))
    for k in theirs:
        assert abs(ours[k] - theirs[k]) <= 1e-4 * max(theirs[k], med), k


def test_flash_readers():
    roof = harness.load_reader("blip_flash_roofline.train")
    share = harness.load_reader("blip_flash_share.train")
    b = fam.flash_bounds(32, 16, 577, 64)
    # the forward is held by its bytes, the dK/dV launch by its products
    assert b["fwd"] == pytest.approx(
        (4 * 32 * 16 * 577 * 64 * 2 + 32 * 16 * 577 * 4) / 3.35e12)
    assert b["dkv"] == pytest.approx(8 * 64 * 32 * 16 * 577 ** 2 / 989e12)
    # dQ reads Q, K, V, dO and writes dQ (5 tensors): held by its products
    assert 5 * 32 * 16 * 577 * 64 * 2 / 3.35e12 < b["dq"]
    assert b["dq"] == pytest.approx(6 * 64 * 32 * 16 * 577 ** 2 / 989e12)
    rec = {"kind": "train", "profiled": {
        "summary": {"busy_s": 2.0}, "micros": 4, "flash_launches": 96,
        "flash": {"fwd": (96, 0.1), "dq": (96, 0.2), "dkv": (96, 0.2)},
        "flash_bound_s": {"fwd": 0.05, "dq": 0.05, "dkv": 0.1}}}
    assert roof(rec) == pytest.approx(40.0)
    assert share(rec) == pytest.approx(25.0)
    short = copy.deepcopy(rec)
    short["profiled"]["flash"]["dq"] = (95, 0.2)
    assert roof(short) is None and share(short) is not None
    git = {"kind": "train", "profiled": {"summary": {"busy_s": 1.0},
                                         "micros": 1}}
    assert roof(git) is None and share(git) is None


def test_update_flops_are_mostly_the_vision_tower():
    """At the published widths a micro of 8 questions x 4 frames is about
    38 TFLOP, the vision tower about 95 % of it."""
    c = tiny._read("configs", "blip_large.json")
    lens = [np.full(8, 9)]
    total = fam.update_flops(c, (1, 8, 4, 20), lens)
    vis = 3.0 * fam.vision_fwd(c, 32)
    assert 35e12 < total < 40e12
    assert 0.93 < vis / total < 0.97
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert {"blipl_msvd_train", "git_msrvtt_mif2_train"} <= {
        w["name"] for w in bench["workloads"]}
