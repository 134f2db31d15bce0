"""TGIF-QA multiple choice in the port vs the JAX package, in f32 on the
CPU at tiny size (tiny-clip, tiny-blip, img 32): ``multiple_choice``'s
logits, loss and every gradient, one K=2 scan update of the MC step, the
loader's report on an MC model, the GIT refusal, and ``start_training``
on ``make_synthetic_mc_dataset`` fixtures (CLIP on ``action``, BLIP on
``transition``) against the JAX loop from the same init."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.core import logging as jlogging
from sasvqa_tpu.core.config import ConfigDict as JConfigDict
from sasvqa_tpu.core.config import get_video_qa_args as jget_args
from sasvqa_tpu.data.pipeline import stack_microbatches as jax_stack
from sasvqa_tpu.data.synthetic import make_synthetic_mc_dataset
from sasvqa_tpu.models import convert as jconvert
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.tasks import run_video_qa as jrun
from sasvqa_tpu.train import steps as jsteps

from sasvqa_torch.core import logging as tlogging
from sasvqa_torch.core.config import get_video_qa_args
from sasvqa_torch.data.pipeline import stack_microbatches
from sasvqa_torch.models import presets as tpresets
from sasvqa_torch.models.convert import state_dict_from_flax
from sasvqa_torch.tasks import run_video_qa as trun
from sasvqa_torch.train import steps as tsteps

from sasvqa_torch.tools import hf_checkpoint as hfc

from _torch_parity import frames, load_flax_params, numpy_tree, to_torch

# multiple choice in f32: logits, loss and each gradient within 1e-5
# relative, the gradients relative to their tensor's largest magnitude
# (XLA and ATen sum in different orders); biases whose gradient is 0 and
# comes back as rounding noise (SHIFT_INVARIANT, key biases) within 1e-6
# absolute
REL = 1e-5
# the JAX-vs-port loops' per-update losses
LOSS_TOL = 1e-5
N_OPTIONS = 5
MODELS = ("tiny-clip", "tiny-blip")


def _model_cfg(model, task="action"):
    """The tiny model's config with the head settings of
    configs/msvd_qa_base3.json (mlp classifier: the MC head ignores it)."""
    return {"model": {"pretrained_model": model, "vocab_size": 512,
                      "hidden_dropout_prob": 0.0},
            "img_size": 32, "num_labels": N_OPTIONS, "classifier": "mlp",
            "task": task, "seed": 0}


def _jax_mc_init(cfg):
    """The params the JAX loop initialises for multiple choice
    (``method="multiple_choice"``; the draws depend on the key and the
    module tree, not on the probe's values)."""
    _, jm = jpresets.build_model(JConfigDict(cfg), dtype=jnp.float32)
    ids = jnp.ones((N_OPTIONS, 4), jnp.int32)
    img = cfg["img_size"]
    params = jax.jit(lambda k, i, m, p: jm.init(
        k, i, m, p, N_OPTIONS, method="multiple_choice"))(
        jax.random.key(cfg["seed"]), ids, ids, jnp.zeros((1, 1, img, img, 3)))
    return jm, params


@pytest.fixture(scope="module")
def models():
    """model name -> (JAX model, its MC init, the port model carried over
    with load_state_dict(strict=True))."""
    out = {}
    for name in MODELS:
        cfg = _model_cfg(name)
        jm, params = _jax_mc_init(cfg)
        _, tm = tpresets.build_model(cfg, device="cpu")
        out[name] = (jm, params, load_flax_params(tm, params))
    return out


def _close_rel(ours, ref, name, rel=REL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()),
                               err_msg=name)


# the mc_head's last bias before the score and the score's own bias add
# the same constant to every option of a question, which the softmax over
# the options cancels: their true gradient is 0, as a key bias's
SHIFT_INVARIANT = ("mc_head.attention.layers_0.norm3.bias",
                   "mc_head.classifier.bias")


def _close_key_bias(ours, ref, name):
    """Softmax does not change when a constant is added to every key (or
    every option), so such a bias has a true gradient of 0: both
    frameworks hand back f32 rounding noise there, held to 1e-6."""
    np.testing.assert_allclose(ours, ref, atol=1e-6, err_msg=name)


def _mc_batch(videos=3, t=2, l=8, seed=0):
    """``videos`` questions of N_OPTIONS option rows each."""
    rng = np.random.default_rng(seed)
    rows = videos * N_OPTIONS
    ids = rng.integers(5, 512, size=(rows, l)).astype(np.int32)
    mask = np.ones((rows, l), np.int32)
    for r in range(rows):
        mask[r, 3 + r % (l - 3):] = 0
    px = np.stack([frames(seed + v, t, 32) for v in range(videos)])
    labels = rng.integers(0, N_OPTIONS, size=(videos,)).astype(np.int32)
    return {"text_input_ids": ids, "text_attention_mask": mask,
            "visual_inputs": px, "labels": labels}


def test_mc_models_hold_only_the_mc_head(models):
    """As the JAX MC init: ``mc_head`` (linear, one score) and no
    ``answer_head``, even where the config asks for an mlp classifier;
    the answer-classifier call has no head to run."""
    for name, (_, params, tm) in models.items():
        assert "mc_head" in params["params"]
        assert "answer_head" not in params["params"]
        assert set(state_dict_from_flax(numpy_tree(params))) == \
            set(tm.state_dict())
        assert tm.mc_head.cls_fc is None
        assert tm.mc_head.classifier.weight.shape[0] == 1
        with pytest.raises(AttributeError, match="answer_head"):
            tm(*[to_torch(x) for x in (np.ones((5, 4), np.int64),) * 2],
               to_torch(np.zeros((1, 1, 32, 32, 3), np.float32)))


@pytest.mark.parametrize("name", MODELS)
def test_multiple_choice_logits_loss_and_grads_match_jax(models, name):
    """3 videos of 2 frames, 15 option rows: logits (3, 5), the CE loss on
    option indices and every parameter's gradient equal Flax's
    ``method="multiple_choice"`` within 1e-5 relative."""
    jm, params, tm = models[name]
    bt = _mc_batch()

    def loss_fn(p):
        out = jm.apply(p, bt["text_input_ids"], bt["text_attention_mask"],
                       bt["visual_inputs"], N_OPTIONS, labels=bt["labels"],
                       method="multiple_choice")
        return out["loss"], out["logits"]

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tm.zero_grad()
    out = tm.multiple_choice(to_torch(bt["text_input_ids"], torch.long),
                             to_torch(bt["text_attention_mask"]),
                             to_torch(bt["visual_inputs"]), N_OPTIONS,
                             labels=to_torch(bt["labels"], torch.long))
    out["loss"].backward()
    assert out["logits"].shape == (3, N_OPTIONS)
    _close_rel(out["logits"], jlogits, "logits")
    _close_rel(out["loss"], jloss, "loss")
    ref = state_dict_from_flax(numpy_tree(jgrads))
    for pname, p in tm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        (no, nr), (ours, want) = _noise_grad_parts(
            pname, grad.detach().numpy(), ref[pname].numpy())
        _close_key_bias(no, nr, pname)
        if want.size:
            _close_rel(ours, want, pname)


def _noise_grad_parts(pname, ours, ref):
    """(the parts of a parameter whose gradient is rounding noise, the
    rest) of ``ours`` and ``ref``, as numpy pairs."""
    if pname.endswith("qkv.bias"):      # the K third is a key bias
        d = ref.shape[0] // 3
        return ((ours[d:2 * d], ref[d:2 * d]),
                (np.delete(ours, np.s_[d:2 * d]),
                 np.delete(ref, np.s_[d:2 * d])))
    if pname.endswith(("key.bias", "k_proj.bias")) \
            or pname in SHIFT_INVARIANT:
        return (ours, ref), (ours[:0], ref[:0])
    return (ours[:0], ref[:0]), (ours, ref)


def _close_params(tm, jparams, lr):
    """Updated params within 1 % of one Adam step (lr): g / (|g| + eps)
    is scale-free, so an element whose gradient is near eps or its f32
    rounding moves by a noisy fraction of lr; where the gradient is
    rounding noise altogether Adam steps by lr in a noisy direction, so
    those elements are held within 2 lr."""
    ref = state_dict_from_flax(numpy_tree(jparams))
    for pname, p in tm.named_parameters():
        (no, nr), (ours, want) = _noise_grad_parts(
            pname, p.detach().numpy(), ref[pname].numpy())
        np.testing.assert_allclose(no, nr, atol=2 * lr, err_msg=pname)
        np.testing.assert_allclose(ours, want, atol=0.01 * lr, rtol=0,
                                   err_msg=pname)


@pytest.mark.parametrize("name", MODELS)
def test_mc_scan_update_matches_jax(models, name):
    """One update of K=2 micros through make_scan_train_step(k, "mc")
    under the base3 adam: loss, grad_norm, accuracy counts and the
    updated params equal the JAX scan step's."""
    jm, params, _ = models[name]
    _, tm = tpresets.build_model(_model_cfg(name), device="cpu")
    load_flax_params(tm, params)
    cfg = dict(optim="adam", learning_rate=1e-3, betas=[0.9, 0.999],
               grad_norm=5.0, decay="constant",
               gradient_accumulation_steps=2, scan_accum=1)
    micros = [_mc_batch(videos=2, t=1, seed=20 + i) for i in range(2)]
    jstate = jsteps.create_train_state(
        jm, jax.tree_util.tree_map(jnp.array, params), JConfigDict(cfg), 1)
    jbatch = next(jax_stack(iter(micros), 2))
    jstate, jmet = jsteps.make_scan_train_step(2, "mc", n_options=N_OPTIONS)(
        jstate, jbatch, jax.random.key(1))
    state = tsteps.create_train_state(tm, cfg, 1, device="cpu")
    step = tsteps.make_scan_train_step(2, "mc", device="cpu",
                                       n_options=N_OPTIONS)
    state, met = step(state, next(stack_microbatches(iter(micros), 2)), 1)
    _close_rel(met["loss"], jmet["loss"], "loss")
    _close_rel(met["grad_norm"], jmet["grad_norm"], "grad_norm")
    assert int(met["acc_correct"]) == int(jmet["acc_correct"])
    assert int(met["acc_total"]) == int(jmet["acc_total"]) == 4
    assert state.step == int(jstate.step) == 2
    _close_params(tm, jstate.params, cfg["learning_rate"])


def test_mc_one_micro_step_and_eval_step():
    """The one-micro MC step reports no grad_norm (as the JAX step); the
    eval step returns one option index a question."""
    _, tm = tpresets.build_model(_model_cfg("tiny-clip"), device="cpu")
    state = tsteps.create_train_state(tm, {"learning_rate": 1e-3}, 1,
                                      device="cpu")
    bt = _mc_batch(videos=2, t=1)
    state, met = tsteps.make_mc_train_step(N_OPTIONS, "cpu")(state, bt, 0)
    assert set(met) == {"loss", "acc_correct", "acc_total"}
    assert int(met["acc_total"]) == 2 and state.step == 1
    preds, _ = tsteps.make_mc_eval_step(tm, N_OPTIONS, "cpu")(bt)
    assert preds.shape == (2,) and int(preds.max()) < N_OPTIONS


def test_git_multiple_choice_raises():
    with pytest.raises(ValueError, match="multiple-choice"):
        tpresets.build_model(dict(_model_cfg("tiny-git"), task="transition"),
                             device="cpu")


def test_loader_report_on_an_mc_model_equals_jax(models, tmp_path,
                                                 monkeypatch):
    """A seeded checkpoint in HF CLIPModel names loaded onto the MC model:
    the same report as the JAX loader's (``mc_head`` kept from init) and
    bit-equal leaves."""
    jm, params, _ = models["tiny-clip"]
    path, _, _ = hfc.write_hf_checkpoint(
        str(tmp_path / "clip"), hfc.hf_clip_shapes(
            *tpresets._clip_configs("tiny-clip")), seed=3)
    reports = []
    real = jconvert.merge_pretrained

    def capture(init, converted):
        merged, report = real(init, converted)
        reports.append(report)
        return merged, report

    monkeypatch.setattr(jconvert, "merge_pretrained", capture)
    jloaded = jpresets.load_pretrained_params("clip", jm, params, path)
    _, tm = tpresets.build_model(_model_cfg("tiny-clip"), device="cpu")
    load_flax_params(tm, params)
    report = tpresets.load_pretrained_params("clip", tm, path)
    assert report == reports[0]
    assert report["missing_in_ckpt"] == ["/mc_head"]
    got = tm.state_dict()
    for key, val in state_dict_from_flax(numpy_tree(jloaded)).items():
        assert torch.equal(got[key], val), key


# ---- the task loop -----------------------------------------------------------

@pytest.fixture(scope="module")
def mc_data(tmp_path_factory):
    """task -> TGIF-format fixtures: 4 GIFs, one 5-option question each."""
    return {task: make_synthetic_mc_dataset(
        str(tmp_path_factory.mktemp(task)), task=task, num_videos=4,
        stored_frames=8, img_hw=32) for task in ("action", "transition")}


def _loop_cfg(paths, task, model, out):
    """3 updates of 2 micros of 2 questions (10 option rows), f32,
    dropouts off, zero-eval, one in-loop validation and the final one.
    One question a group: both packages' MC models repeat a video over
    its options only (configs/msvd_qa_base3.json groups by 1 too).  Text
    of 24 tokens holds question and option (19 tokens): a shorter one cuts
    the option off and ties the five scores."""
    cfg = _model_cfg(model, task)
    cfg.update({
        "train_datasets": [{"name": task, "txt": paths["train"],
                            "img": paths["h5"]}],
        "val_datasets": [{"name": task, "txt": paths["val"],
                          "img": paths["h5"]}],
        "inference_txt_db": paths["test"], "inference_img_db": paths["h5"],
        "vid_mapping": paths["vidmapping"], "nframe": 2,
        "samp_policy": "uniform", "max_n_example_per_group": 1,
        "train_batch_size": 2, "val_batch_size": 3,
        "inference_batch_size": 3, "gradient_accumulation_steps": 2,
        "num_train_epochs": 3, "min_valid_steps": 1, "num_valid": 2,
        "learning_rate": 1e-3, "decay": "constant", "optim": "adamw",
        "platform": "cpu", "mesh_shape": [1], "bf16": 0, "zero_eval": 1,
        "output_dir": str(out), "max_txt_len": 24})
    del cfg["num_labels"]      # the task sets it: 5 options
    return cfg


def _scalars(out, tag="train/loss"):
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


@pytest.fixture(scope="module")
def mc_loops(mc_data, tmp_path_factory):
    """(model, task) -> the JAX and the port ``start_training`` from the
    same MC init, each run once for the module."""
    cache = {}

    def get(model, task):
        if (model, task) in cache:
            return cache[(model, task)]
        root = tmp_path_factory.mktemp("mcruns")
        out = {}
        for pkg in ("jax", "port"):
            jlogging.TB_LOGGER.global_step = 0
            tlogging.TB_LOGGER.global_step = 0
            cfg = _loop_cfg(mc_data[task], task, model, root / pkg)
            path = root / f"{pkg}.json"
            path.write_text(json.dumps(cfg))
            argv = ["--task", task, "--config", str(path)]
            if pkg == "jax":
                result = jrun.start_training(jget_args(argv))
            else:
                _, params = _jax_mc_init(cfg)
                mp = pytest.MonkeyPatch()
                real = trun.build_model
                mp.setattr(trun, "build_model", lambda c, **kw: (
                    lambda fm: (fm[0], load_flax_params(fm[1], params)))(
                        real(c, **kw)))
                try:
                    result = trun.start_training(get_video_qa_args(argv))
                finally:
                    mp.undo()
            out[pkg] = dict(result=result, out=str(root / pkg))
        cache[(model, task)] = out
        return out

    return get


@pytest.mark.parametrize("model,task", [("tiny-clip", "action"),
                                        ("tiny-blip", "transition")])
def test_mc_loop_losses_and_scores_match_jax(mc_loops, model, task):
    """Both loops: per-update losses within 1e-5, the same learning rates,
    equal zero-eval, val and test scores, no per-type metrics."""
    pair = mc_loops(model, task)
    j, t = pair["jax"], pair["port"]
    jl, tl = _scalars(j["out"]), _scalars(t["out"])
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    np.testing.assert_allclose([tl[s] for s in (1, 2, 3)],
                               [jl[s] for s in (1, 2, 3)], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert _scalars(t["out"], "train/lr") == _scalars(j["out"], "train/lr")
    for tag in ("zero_valid/overall_acc", "zero_test/overall_acc"):
        assert _scalars(t["out"], tag) == _scalars(j["out"], tag)
    assert t["result"]["global_step"] == j["result"]["global_step"] == 3
    for split in ("val", "test"):
        assert t["result"][split] == j["result"][split]
        assert "overall_acc" in t["result"][split]
        assert "what_acc" not in t["result"][split]
    assert sorted(os.listdir(os.path.join(t["out"], "ckpt"))) == \
        ["model_step_2.pt", "model_step_3.pt"]
