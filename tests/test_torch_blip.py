"""Port BLIP classifier slice vs the JAX package, in f32 on the CPU: the
vision tower at 577 tokens a frame, the cross-attending text encoder with
asymmetric widths, the three fusion variants, BLIPVideoQA's logits, loss
and gradients, the classification losses, ClassifierCollator, the
8-micro classifier scan trajectory under adam, and QAEngine answers."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.data import dataset as jdataset
from sasvqa_tpu.data import tokenization as jtok
from sasvqa_tpu.data.pipeline import stack_microbatches as jax_stack
from sasvqa_tpu.models import blip as jblip
from sasvqa_tpu.models import fusion as jfusion
from sasvqa_tpu.models import video_qa as jvqa
from sasvqa_tpu.models.presets import build_model as jax_build_model
from sasvqa_tpu.tasks import serve as jserve
from sasvqa_tpu.train import steps as jsteps

import torch

from sasvqa_torch.data import dataset as tdataset
from sasvqa_torch.data import tokenization as ttok
from sasvqa_torch.data.pipeline import stack_microbatches
from sasvqa_torch.models import blip as tblip
from sasvqa_torch.models import fusion as tfusion
from sasvqa_torch.models import video_qa as tvqa
from sasvqa_torch.models.convert import state_dict_from_flax
from sasvqa_torch.models.presets import build_model
from sasvqa_torch.ops import _build
from sasvqa_torch.tasks import serve as tserve
from sasvqa_torch.train import steps as tsteps

from _torch_parity import frames, load_flax_params, numpy_tree, to_torch

# f32 forwards and gradients of 2-layer models: summation order differs
# between XLA and ATen
ATOL, RTOL = 2e-5, 2e-4

ANS = {"dog": 0, "cat": 1, "red": 2, "ball": 3, "man": 4}
TINY_BLIP = {"model": {"pretrained_model": "tiny-blip",
                       "hidden_dropout_prob": 0.0},
             "img_size": 32, "num_labels": len(ANS), "classifier": "mlp"}


def _close(ours, ref, err_msg="", atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours,
        np.asarray(ref), atol=atol, rtol=rtol, err_msg=err_msg)


def _init(module, *args, **kw):
    return jax.jit(lambda *a: module.init(jax.random.key(0), *a, **kw))(
        *args)


# ---- towers and the fusion head --------------------------------------------

def test_vision_tower_at_577_tokens_matches_jax():
    """BLIP vision at 384x384 / patch 16: 577 tokens a frame, so the
    >= 512 route decision runs (CPU tensors: plain).  Hidden states (post-LN)
    and the twice post-LN'd pooled CLS equal the Flax tower's."""
    cfg = jblip.BLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                 num_layers=2, num_heads=4, image_size=384,
                                 patch_size=16)
    px = np.random.default_rng(0).normal(size=(2, 384, 384, 3)).astype(
        np.float32)
    jm = jblip.BLIPVisionEncoder(cfg)
    params = _init(jm, jnp.asarray(px))
    jh, jp = jm.apply(params, jnp.asarray(px))
    tm = load_flax_params(
        tblip.BLIPVisionEncoder(tblip.BLIPVisionConfig(
            **dataclasses.asdict(cfg))), params)
    assert tm.config.tokens_per_frame == 577
    th, tp = tm(to_torch(px))
    assert th.shape == (2, 577, 32)
    _close(th, jh, "hidden")
    _close(tp, jp, "pooled")


def test_text_encoder_cross_attends_with_asymmetric_widths():
    """Text width 32 cross-attending to 48-wide encoder states (the
    blip-large asymmetry): key/value project into the query width."""
    cfg = jblip.BLIPTextConfig(vocab_size=64, hidden_size=32,
                               intermediate_size=64, num_layers=2,
                               num_heads=4, max_position_embeddings=16,
                               encoder_width=48)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, size=(3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 4:] = 0
    enc = rng.normal(size=(3, 11, 48)).astype(np.float32)
    jm = jblip.BLIPTextEncoder(cfg)
    params = _init(jm, ids, mask, jnp.asarray(enc))
    jh, jp = jm.apply(params, ids, mask, jnp.asarray(enc))
    tm = load_flax_params(tblip.BLIPTextEncoder(tblip.BLIPTextConfig(
        **dataclasses.asdict(cfg))), params)
    assert tm.layers_0.crossattention.key.weight.shape == (32, 48)
    th, tp = tm(to_torch(ids, torch.long), to_torch(mask), to_torch(enc))
    _close(th, jh, "hidden")
    _close(tp, jp, "pooled")


@pytest.mark.parametrize("attn_type,classifier", [
    ("dec-only", "mlp"), ("enc-dec", "linear"), ("dec-cas", "mlp")])
def test_answer_classifier_variants_match_jax(attn_type, classifier):
    """The zero decoded token, each fusion variant over 48-wide frame
    embeddings and a 32-wide text, position-0 pooling and the linear/mlp
    classifier: logits equal the Flax head's."""
    rng = np.random.default_rng(2)
    txt = rng.normal(size=(3, 6, 32)).astype(np.float32)
    mask = np.ones((3, 6), np.int32)
    mask[2, 3:] = 0
    vis = rng.normal(size=(3, 4, 48)).astype(np.float32)
    jm = jfusion.AnswerClassifier(num_labels=7, classifier=classifier,
                                  attn_type=attn_type)
    params = _init(jm, jnp.asarray(txt), mask, jnp.asarray(vis))
    ref = jm.apply(params, jnp.asarray(txt), mask, jnp.asarray(vis))
    tm = load_flax_params(tfusion.AnswerClassifier(
        32, 7, vis_size=48, classifier=classifier, attn_type=attn_type),
        params)
    _close(tm(to_torch(txt), to_torch(mask), to_torch(vis)), ref, attn_type)


@pytest.mark.parametrize("loss_type", ["ce", "bce", "mse"])
def test_classification_losses_match_jax(loss_type):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 4)).astype(np.float32)
    if loss_type == "ce":
        labels = np.array([0, 3, -100, 2, 1], np.int32)
    elif loss_type == "bce":
        labels = (rng.random((5, 4)) < 0.3).astype(np.float32)
    else:
        labels = rng.normal(size=(20,)).astype(np.float32)
    ref = jvqa.classification_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   loss_type)
    ours = tvqa.classification_loss(to_torch(logits), to_torch(labels),
                                    loss_type)
    _close(ours, ref, loss_type, atol=1e-6, rtol=1e-6)


# ---- the whole model -----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_blip():
    """The JAX tiny BLIPVideoQA, its params, and the port's model carried
    over from them with load_state_dict(strict=True)."""
    family, jm = jax_build_model(ConfigDict(TINY_BLIP), dtype=jnp.float32)
    ids = jnp.ones((2, 5), jnp.int32)
    params = _init(jm, ids, ids, jnp.zeros((2, 2, 32, 32, 3)))
    fam, tm = build_model(TINY_BLIP, device="cpu")
    assert family == fam == "blip"
    load_flax_params(tm, params)
    return jm, params, tm


def test_weights_carry_over_leaf_by_leaf(tiny_blip):
    """Every Flax leaf maps onto one port parameter, including the raw
    (1, P, D) position_embedding and (1, 1, D) class_embedding."""
    _, params, tm = tiny_blip
    sd = state_dict_from_flax(numpy_tree(params))
    assert set(sd) == set(tm.state_dict())
    pos = np.asarray(params["params"]["vis_model"]["position_embedding"])
    assert pos.shape == (1, 5, 32)
    np.testing.assert_array_equal(tm.vis_model.position_embedding.detach()
                                  .numpy(), pos)
    np.testing.assert_array_equal(
        tm.vis_model.class_embedding.detach().numpy(),
        np.asarray(params["params"]["vis_model"]["class_embedding"]))


def _batch(b=4, videos=2, t=2, l=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 512, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1:, 5:] = 0
    mask[3:, 2:] = 0
    labels = rng.integers(0, len(ANS), size=(b,)).astype(np.int32)
    labels[b // 2] = -100
    px = rng.normal(size=(videos, t, 32, 32, 3)).astype(np.float32)
    return {"text_input_ids": ids, "text_attention_mask": mask,
            "visual_inputs": px, "labels": labels}


def _key_bias(name):
    """Softmax does not change when a constant is added to every key, so
    a key projection's bias has a true gradient of 0: both frameworks
    hand back f32 rounding noise there."""
    return name.endswith(("key.bias", "k_proj.bias"))


def _close_params(ours, ref, name, atol, key_bias_atol):
    """``_close`` with ``key_bias_atol`` on key biases, including the K
    third of a fused qkv bias."""
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    if _key_bias(name):
        atol = key_bias_atol
    elif name.endswith("qkv.bias"):
        d = ref.shape[0] // 3
        _close(ours[d:2 * d], ref[d:2 * d], name, atol=key_bias_atol)
        ours, ref = np.delete(ours, np.s_[d:2 * d]), \
            np.delete(ref, np.s_[d:2 * d])
    _close(ours, ref, name, atol=atol)


def test_logits_loss_and_grads_match_jax(tiny_blip):
    """Logits, CE loss (one label ignored) and every parameter's
    gradient, with 2 examples per video (the post-encoder repeat)."""
    jm, params, tm = tiny_blip
    bt = _batch()

    def loss_fn(p):
        out = jm.apply(p, bt["text_input_ids"], bt["text_attention_mask"],
                       bt["visual_inputs"], labels=bt["labels"],
                       deterministic=False,
                       rngs={"dropout": jax.random.key(1)})
        return out["loss"], out["logits"]

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tm.zero_grad()
    out = tm(to_torch(bt["text_input_ids"], torch.long),
             to_torch(bt["text_attention_mask"]),
             to_torch(bt["visual_inputs"]),
             labels=to_torch(bt["labels"], torch.long), deterministic=False,
             generator=torch.Generator().manual_seed(1))
    out["loss"].backward()
    _close(out["logits"], jlogits, "logits")
    _close(out["loss"], jloss, "loss")
    ref = state_dict_from_flax(numpy_tree(jgrads))
    for name, p in tm.named_parameters():
        # the text pooler feeds nothing: no grad here, zeros in JAX
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close_params(grad, ref[name], name, ATOL, 1e-6)
    assert tm.vis_model.layers_0.self_attn.qkv.weight.grad.abs().sum() > 0


# ---- data, training, serving ------------------------------------------------

QUESTIONS = ["what is the man doing?", "Who plays with the red ball",
             "where is the dog running in the video frame", "how"]


def _items(n_groups=4, k=6, img=32, group=1, seed=0, labels=True):
    items = []
    for i in range(n_groups):
        exs = [{"q_str": QUESTIONS[(i + j) % len(QUESTIONS)],
                "str_label": None,
                "label": (i + j) % len(ANS) if labels else None,
                "options_str_list": ["a dog", "the red ball", "cat",
                                     "man running", "blue"],
                "question_id": i * group + j} for j in range(group)]
        items.append({"vid": frames(seed + i, k, img), "examples": exs,
                      "n_examples": group})
    return items


@pytest.mark.parametrize("task,pixel_dtype,labels", [
    ("msvd_qa", "f32", True), ("msvd_qa", "u8", False),
    ("action", "f32", True)])
def test_classifier_collator_matches_jax(task, pixel_dtype, labels):
    kw = dict(max_txt_len=9, task_type=task, nframe=3, samp_policy="random",
              pixel_dtype=pixel_dtype)
    ref_col = jdataset.ClassifierCollator(jtok.make_test_wordpiece(), **kw)
    our_col = tdataset.ClassifierCollator(ttok.make_test_wordpiece(), **kw)
    items = _items(group=2, labels=labels)
    ref = ref_col(items, rng=np.random.default_rng(5))
    ours = our_col(items, rng=np.random.default_rng(5))
    assert set(ours) == set(ref)
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            assert ours[key].dtype == val.dtype, key
            np.testing.assert_array_equal(ours[key], val, err_msg=key)
        else:
            assert ours[key] == val, key
    assert isinstance(tdataset.make_collator(
        "blip", ttok.make_test_wordpiece(), {"stage_pixels_u8": 1}),
        tdataset.ClassifierCollator)


def _adam_cfg(k):
    return dict(optim="adam", learning_rate=1e-3, betas=[0.9, 0.999],
                weight_decay=1e-3, grad_norm=0.5, decay="constant",
                gradient_accumulation_steps=k, scan_accum=1)


def test_classifier_scan_trajectory_matches_jax(tiny_blip):
    """8 micro-batches as 4 updates of K=2 through
    make_scan_train_step(family="classifier") under adam (no weight decay
    although the config sets one, as optax.adam): each update's loss,
    grad_norm and accuracy counts and the final params equal the JAX scan
    step's.  The head's dropout is 0: the packages draw different
    numbers."""
    jm, params, _ = tiny_blip
    k, total = 2, 4
    _, tm = build_model(TINY_BLIP, device="cpu")
    load_flax_params(tm, params)
    micros = [_batch(b=2, videos=2, t=1, l=6, seed=10 + i)
              for i in range(8)]
    cfg = _adam_cfg(k)
    jstate = jsteps.create_train_state(
        jm, jax.tree_util.tree_map(jnp.array, params), ConfigDict(cfg),
        total)
    jstep = jsteps.make_scan_train_step(k, "classifier")
    state = tsteps.create_train_state(tm, cfg, total, device="cpu")
    assert state.optimizer.weight_decay == 0.0
    step = tsteps.make_scan_train_step(k, "classifier", device="cpu")
    key = jax.random.key(3)
    for jb, tb in zip(jax_stack(iter(micros), k),
                      stack_microbatches(iter(micros), k)):
        jstate, jmet = jstep(jstate, jb, key)
        state, met = step(state, tb, 3)
        _close(met["loss"], jmet["loss"], "loss")
        _close(met["grad_norm"], jmet["grad_norm"], "grad_norm", rtol=1e-4)
        assert int(met["acc_correct"]) == int(jmet["acc_correct"])
        assert int(met["acc_total"]) == int(jmet["acc_total"]) == k
    assert state.step == int(jstate.step) == 8
    ref = state_dict_from_flax(numpy_tree(jstate.params))
    for name, p in tm.named_parameters():
        # four clipped Adam updates of size <= lr (1e-3): m/sqrt(v) is
        # scale-free, so an element whose gradient is near its f32
        # rounding noise steps in a noisy direction; 1e-5 is 1 % of one
        # update.  A key bias, whose gradient is rounding noise, moves by
        # up to 4 updates of lr.
        _close_params(p, ref[name], name, 1e-5, 4 * 1e-3 * 2)


def test_classifier_eval_steps(tiny_blip):
    """The eval step's argmax and loss and the logits step agree with the
    model's forward; make_classifier_train_step is a one-micro scan."""
    _, params, tm = tiny_blip
    bt = _batch(seed=20)
    with torch.no_grad():
        out = tm(to_torch(bt["text_input_ids"], torch.long),
                 to_torch(bt["text_attention_mask"]),
                 to_torch(bt["visual_inputs"]),
                 labels=to_torch(bt["labels"], torch.long))
    preds, loss = tsteps.make_classifier_eval_step(tm, device="cpu")(bt)
    assert torch.equal(preds, out["logits"].argmax(-1))
    assert loss.item() == out["loss"].item()
    logits = tsteps.make_classifier_logits_step(tm, device="cpu")(bt)
    assert torch.equal(logits, out["logits"])

    models = []
    for _ in range(2):
        _, m = build_model(TINY_BLIP, device="cpu")
        models.append(load_flax_params(m, params))
    cfg = _adam_cfg(1)
    sa = tsteps.create_train_state(models[0], cfg, 2, device="cpu")
    sb = tsteps.create_train_state(models[1], cfg, 2, device="cpu")
    sa, ma = tsteps.make_classifier_train_step(device="cpu")(sa, bt, 11)
    sb, mb = tsteps.make_scan_train_step(1, "classifier", device="cpu")(
        sb, {key: val[None] for key, val in bt.items()}, 11)
    assert ma["loss"].item() == mb["loss"].item()
    assert int(ma["acc_total"]) == 3
    for pa, pb in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(pa, pb)


ENGINE_KW = dict(nframe=2, samp_policy="uniform", batch_size=4,
                 linger_ms=30.0, max_txt_len=8)


def test_qa_engine_answers_match_jax_engine(tiny_blip):
    """QAEngine(family="blip", device="cpu") answers 6 requests (two
    batches, the second padded) exactly as the JAX engine does on the
    same weights; classifier serving needs ans2label; the model never
    reaches a kernel on the CPU."""
    jm, params, tm = tiny_blip
    questions = ["what is the dog doing", "who is in the video",
                 "what color is the ball", "where is the cat running",
                 "how", "what is the man doing"]
    reqs = [(frames(30 + i, 6, 32), questions[i]) for i in range(6)]
    with jserve.QAEngine(jm, params, "blip", jtok.make_test_wordpiece(),
                         ans2label=ANS, **ENGINE_KW) as jeng:
        ref = [jeng.answer(f, q, timeout=300) for f, q in reqs]
    _build.reset_launch_counts()
    with tserve.QAEngine(tm, "blip", ttok.make_test_wordpiece(),
                         ans2label=ANS, device="cpu", **ENGINE_KW) as eng:
        futs = [eng.submit(f, q) for f, q in reqs]
        ours = [f.result(timeout=300) for f in futs]
    assert ours == ref
    assert all(o["answer"] in ANS for o in ours)
    assert not any(_build.launch_counts.values())
    with pytest.raises(ValueError, match="ans2label"):
        tserve.QAEngine(tm, "blip", ttok.make_test_wordpiece(),
                        device="cpu")
