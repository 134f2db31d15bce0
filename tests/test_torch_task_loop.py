"""The port's task loop (config, datasets, input pipeline, checkpoints,
``validate`` and ``start_training``) vs the JAX package's, on the CPU at
tiny size (img 32; tiny-git, tiny-blip and tiny-clip, the last from a
saved HF checkpoint named by ``model.pretrained_weights``), on
``sasvqa_tpu.data.synthetic`` fixtures: the same config, datalists,
answer vocabulary, batches, validation results and per-update losses; and
the port's own snapshots, inference restore, preempt-and-resume,
prefetcher shutdown, device rule and a classifier overfit gate."""

import json
import os
import random
import shutil
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.core import logging as jlogging
from sasvqa_tpu.core.config import ConfigDict as JConfigDict
from sasvqa_tpu.core.config import get_video_qa_args as jget_args
from sasvqa_tpu.data import annotations as jann
from sasvqa_tpu.data import dataset as jds
from sasvqa_tpu.data import pipeline as jpipe
from sasvqa_tpu.data.frame_store import FrameStoreReader as JReader
from sasvqa_tpu.data.frame_store import load_vidmapping as jload_map
from sasvqa_tpu.data.synthetic import make_synthetic_dataset
from sasvqa_tpu.data.tokenization import make_test_wordpiece as jtok
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.tasks import run_video_qa as jrun
from sasvqa_tpu.train import steps as jsteps

from sasvqa_torch.core import logging as tlogging
from sasvqa_torch.core.config import ConfigDict, get_video_qa_args
from sasvqa_torch.data import annotations as tann
from sasvqa_torch.data import dataset as tds
from sasvqa_torch.data import pipeline as tpipe
from sasvqa_torch.data.frame_store import FrameStoreReader, load_vidmapping
from sasvqa_torch.data.tokenization import make_test_wordpiece
from sasvqa_torch.tasks import run_video_qa as trun
from sasvqa_torch.train import steps as tsteps

from _torch_parity import hf_tiny_clip, load_flax_params, save_hf

# the training parity tests' f32 tolerance (tests/test_torch_train.py)
ATOL, RTOL = 2e-5, 2e-4
# the JAX-vs-port loops' per-update losses
LOSS_TOL = 1e-5
FAMILIES = ("tiny-git", "tiny-blip", "tiny-clip")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return make_synthetic_dataset(str(root), num_videos=4, stored_frames=8,
                                  img_hw=32, questions_per_video=2)


def _cfg(paths, out, **overrides):
    """3 updates of 2 micros of 2 groups of 2 questions, f32, dropouts
    off, one in-loop validation (step 2) and the final one."""
    cfg = {
        "task": "msvd_qa",
        "train_datasets": [{"name": "msvd_qa", "txt": paths["train"],
                            "img": paths["h5"]}],
        "val_datasets": [{"name": "msvd_qa", "txt": paths["val"],
                          "img": paths["h5"]}],
        "inference_txt_db": paths["test"], "inference_img_db": paths["h5"],
        "vid_mapping": paths["vidmapping"],
        "model": {"pretrained_model": "tiny-git", "vocab_size": 512,
                  "hidden_dropout_prob": 0.0,
                  "attention_probs_dropout_prob": 0.0},
        "img_size": 32, "nframe": 2, "samp_policy": "uniform",
        "max_n_example_per_group": 2, "train_batch_size": 2,
        "val_batch_size": 4, "inference_batch_size": 4,
        "gradient_accumulation_steps": 2, "num_train_epochs": 3,
        "min_valid_steps": 1, "num_valid": 2, "learning_rate": 1e-3,
        "decay": "constant", "optim": "adamw", "seed": 0,
        "platform": "cpu", "mesh_shape": [1], "bf16": 0,
        "output_dir": str(out),
        "max_txt_len": 16, "gen_max_new_tokens": 4}
    cfg.update(overrides)
    return cfg


def _family_cfg(model, **overrides):
    """``_cfg``'s overrides for ``model`` (tiny-git, tiny-blip or
    tiny-clip): the classifiers with dropout 0 and LogSumExp clip
    pooling (configs/msvd_qa_base3.json's)."""
    if model == "tiny-git":
        return overrides
    return dict({"model": {"pretrained_model": model, "vocab_size": 512,
                           "hidden_dropout_prob": 0.0},
                 "score_agg_func": "lse", "classifier": "mlp"}, **overrides)


def _write(cfg, path):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _args(cfg, path, parse=get_video_qa_args):
    """The loop's config from a JSON file, defaults filled by the parser."""
    return parse(["--task", cfg["task"], "--config", _write(cfg, path)])


def _jax_init(cfg):
    """The params the JAX loop initialises from cfg.seed (the init draws
    depend on the key and the module tree, not on the probe's values, as
    long as the probe's frame count is 1 or more)."""
    _, jm = jpresets.build_model(JConfigDict(cfg), dtype=jnp.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    img = cfg["img_size"]
    return jax.jit(jm.init)(jax.random.key(cfg["seed"]), ids, ids,
                            jnp.zeros((1, 1, img, img, 3)))


def _scalars(out, tag="train/loss"):
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


@pytest.fixture
def jax_init_weights(monkeypatch):
    """Make the port loop's model start from the JAX loop's init."""
    real = trun.build_model

    def build(cfg, **kw):
        family, model = real(cfg, **kw)
        return family, load_flax_params(model, _jax_init(cfg.to_dict()))

    monkeypatch.setattr(trun, "build_model", build)


def _loop_pair(model, synth, root):
    """One JAX loop and one port loop of ``model`` from the same init and
    config; the tiny-clip loops also overlay a saved HF CLIPModel named by
    ``model.pretrained_weights`` (each package with its own loader) and
    validate with 2 clips."""
    over = _family_cfg(model, zero_eval=1)
    if model == "tiny-clip":
        over["model"]["pretrained_weights"] = save_hf(
            hf_tiny_clip(seed=7), root / "weights", "safetensors")
        # the loop's multi-clip branch: 2 random frame draws a question,
        # their logits pooled (tiny-blip takes the 1-clip argmax branch)
        over.update(inference_n_clips=2, samp_policy="random")
    out = {"family": model}
    for pkg in ("jax", "port"):
        # each loop starts as in a fresh process: the scalar logger's step
        # is process-wide in both packages
        jlogging.TB_LOGGER.global_step = tlogging.TB_LOGGER.global_step = 0
        cfg = _cfg(synth, root / pkg, **over)
        path = _write(cfg, root / f"{pkg}.json")
        argv = ["--task", "msvd_qa", "--config", path]
        if pkg == "jax":
            args = jget_args(argv)
            result = jrun.start_training(args)
        else:
            mp = pytest.MonkeyPatch()
            real = trun.build_model
            params = _jax_init(cfg)
            mp.setattr(trun, "build_model", lambda c, **kw: (
                lambda fm: (fm[0], load_flax_params(fm[1], params)))(
                    real(c, **kw)))
            try:
                args = get_video_qa_args(argv)
                result = trun.start_training(args)
            finally:
                mp.undo()
        out[pkg] = dict(cfg=args, result=result, out=str(root / pkg),
                        path=path)
    return out


@pytest.fixture(scope="module")
def loop_pairs(synth, tmp_path_factory):
    """model -> its ``_loop_pair``, each run once for the module."""
    cache = {}

    def get(model):
        if model not in cache:
            cache[model] = _loop_pair(model, synth,
                                      tmp_path_factory.mktemp("runs"))
        return cache[model]

    return get


@pytest.fixture(scope="module")
def runs(loop_pairs):
    """The tiny-git pair: the port-only checks of snapshots and restore
    (plumbing that does not depend on the family)."""
    return loop_pairs("tiny-git")


def test_config_matches_jax(tmp_path):
    cfg = {"task": "msvd_qa", "learning_rate": 1e-5, "nframe": 2,
           "model": {"pretrained_model": "tiny-git"}, "betas": [0.9, 0.99],
           "train_datasets": [{"txt": "a.json", "img": "b.h5"}],
           "debug": 1, "remat": True}
    path = _write(cfg, tmp_path / "c.json")
    for argv in (["--config", path],
                 ["--config", path, "--learning_rate", "3e-4",
                  "--nframe", "5", "--zero_eval", "1"],
                 ["--task", "msvd_qa", "--seed", "7"]):
        ours, ref = get_video_qa_args(argv), jget_args(argv)
        assert isinstance(ours, ConfigDict)
        assert ours.to_dict() == ref.to_dict()
    ours = get_video_qa_args(["--config", path, "--learning_rate", "3e-4"])
    assert ours.learning_rate == 3e-4 and ours.nframe == 2     # CLI > JSON
    assert ours.train_datasets[0].img == "b.h5" and ours.debug is True


def test_datalists_groups_and_answer_vocab_match(synth):
    for split, is_train in (("train", True), ("val", False)):
        ours = tann.load_datalist("msvd_qa", synth[split])
        ref = jann.load_datalist("msvd_qa", synth[split])
        assert ours == ref
        random.seed(5)
        g_ours = tann.group_datalist(ours, 2, is_train)
        random.seed(5)
        assert g_ours == jann.group_datalist(ref, 2, is_train)
    a2l = tann.build_common_answer_dict([synth["train"]], 1000)
    assert a2l == jann.build_common_answer_dict([synth["train"]], 1000)
    data = tann.load_datalist("msvd_qa", synth["val"])
    qid2data = {d["question_id"]: d for d in data}
    results = [{"question_id": d["question_id"],
                "answer": (a2l.get(d["answer"], 0) if i % 3 else -1)}
               for i, d in enumerate(data)]
    assert tann.evaluate_qa(results, qid2data, a2l, "msvd_qa") == \
        jann.evaluate_qa(results, qid2data, a2l, "msvd_qa")


def _datasets(synth, split, is_train):
    a2l = tann.build_common_answer_dict([synth["train"]], 1000)
    random.seed(1)
    grouped = tann.group_datalist(
        tann.load_datalist("msvd_qa", synth[split]), 2, is_train)
    ours = tds.VideoQADataset("msvd_qa", grouped,
                              FrameStoreReader(synth["h5"]),
                              load_vidmapping(synth["vidmapping"]), a2l,
                              is_train=is_train)
    ref = jds.VideoQADataset("msvd_qa", grouped, JReader(synth["h5"]),
                             jload_map(synth["vidmapping"]), a2l,
                             is_train=is_train)
    return ours, ref, a2l


def test_first_batches_match(synth):
    """The first 3 batches of infinite_batches from the same seed, with
    the 'random' policy drawing from the per-batch generators."""
    ours_ds, ref_ds, _ = _datasets(synth, "train", True)
    cfg = {"max_txt_len": 16, "task": "msvd_qa", "nframe": 3,
           "samp_policy": "random", "bf16": False}
    ours = tpipe.infinite_batches(
        ours_ds, tds.make_collator("git", make_test_wordpiece(), cfg), 3,
        np.random.default_rng(11))
    ref = jpipe.infinite_batches(
        ref_ds, jds.make_collator("git", jtok(), JConfigDict(cfg)), 3,
        np.random.default_rng(11))
    for _ in range(3):   # 4 groups in batches of 3, drop_last: 3 epochs
        a, b = next(ours), next(ref)
        assert set(a) == set(b)
        for key, val in b.items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(a[key], val, err_msg=key)
            else:
                assert a[key] == val, key


@pytest.fixture(scope="module")
def jax_eval(synth, tmp_path_factory):
    """family -> the JAX eval steps, model state and config of the
    validate tests (one compile for both clip counts)."""
    cache = {}

    def get(model):
        if model in cache:
            return cache[model]
        base = _cfg(synth, "unused", samp_policy="random", nframe=3,
                    val_batch_size=4, **_family_cfg(model))
        jcfg = _args(base, tmp_path_factory.mktemp("jeval") / "j.json",
                     jget_args)
        _, jm = jpresets.build_model(jcfg, dtype=jnp.float32)
        params = _jax_init(base)
        state = jsteps.create_train_state(jm, params, jcfg, 1)
        if model == "tiny-git":
            steps = (jsteps.make_git_eval_step(jm, max_new_tokens=4), None)
        else:
            steps = (jsteps.make_classifier_eval_step(None),
                     jsteps.make_classifier_logits_step(None))
        cache[model] = (base, params, jcfg, state, steps)
        return cache[model]

    return get


@pytest.mark.parametrize("n_clips", [1, 2])
@pytest.mark.parametrize("model", FAMILIES)
def test_validate_matches_jax(synth, tmp_path, jax_eval, model, n_clips):
    """Same weights (the JAX init carried over): identical qa_results and
    scores, and the port's are the same at eval batch sizes 3 and 4.  Two
    clips: GIT votes the answers, the classifiers pool the logits
    (LogSumExp)."""
    ours_ds, ref_ds, a2l = _datasets(synth, "val", False)
    base, params, jcfg, jstate, (jstep, jlogits) = jax_eval(model)
    family = model.split("-")[1]
    base = dict(base, inference_n_clips=n_clips)
    jcfg.inference_n_clips = n_clips
    if family == "git":
        jcol = jds.GITCollator(jtok(), max_txt_len=16, nframe=3,
                               samp_policy="random", add_ans=False)
        tcol = tds.GITCollator(make_test_wordpiece(), max_txt_len=16,
                               nframe=3, samp_policy="random", add_ans=False)
    else:
        jcol = jds.ClassifierCollator(jtok(), max_txt_len=16, nframe=3,
                                      samp_policy="random")
        tcol = tds.ClassifierCollator(make_test_wordpiece(), max_txt_len=16,
                                      nframe=3, samp_policy="random")
    ref = jrun.validate(jstate, ref_ds, jcol, jcfg, family, jtok(), a2l,
                        jstep, None,
                        logits_step=jlogits if n_clips > 1 else None)
    tcfg = _args(base, tmp_path / "t.json")
    _, tm = trun.build_model(tcfg, device="cpu")
    load_flax_params(tm, params)
    if family == "git":
        step = tsteps.make_git_eval_step(tm, max_new_tokens=4, device="cpu")
        logits_step = None
    else:
        step = tsteps.make_classifier_eval_step(tm, device="cpu")
        logits_step = tsteps.make_classifier_logits_step(tm, device="cpu")
    for bs in (3, 4):
        tcfg.val_batch_size = bs
        res = trun.validate(ours_ds, tcol, tcfg, make_test_wordpiece(), a2l,
                            step, family=family, logits_step=logits_step)
        assert res["qa_results"] == ref["qa_results"]
        assert res["scores"] == ref["scores"]
    assert {r["question_id"] for r in ref["qa_results"]} == \
        set(ours_ds.qid2data)


@pytest.mark.parametrize("model", FAMILIES)
def test_loop_step_math_losses_and_scores_match_jax(loop_pairs, model):
    """Both start_training loops from the same init (and, for tiny-clip,
    the same loaded checkpoint), dropouts 0: equal step math,
    restore-checkpoint steps and eval snapshots, per-update losses within
    1e-5 and the same final scores."""
    pair = loop_pairs(model)
    j, t = pair["jax"], pair["port"]
    for key in ("num_train_steps", "valid_steps"):
        assert t["cfg"][key] == j["cfg"][key]
    assert t["cfg"].num_train_steps == 3 and t["cfg"].valid_steps == 2
    _, _, save_steps = trun.step_math(t["cfg"], 4)
    assert save_steps == max(int(0.01 * 3 * 2), 1)
    # the JAX restore dir holds one sub-directory per step kept
    jsteps_kept = sorted(int(d) for d in os.listdir(
        os.path.join(j["out"], "restore")) if d.isdigit())
    assert jsteps_kept == [4, 6]
    assert sorted(os.listdir(os.path.join(t["out"], "restore"))) == \
        [f"step_{s}.pt" for s in jsteps_kept]
    assert sorted(os.listdir(os.path.join(t["out"], "ckpt"))) == \
        ["model_step_2.pt", "model_step_3.pt"]
    jl, tl = _scalars(j["out"]), _scalars(t["out"])
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    np.testing.assert_allclose([tl[s] for s in (1, 2, 3)],
                               [jl[s] for s in (1, 2, 3)], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert _scalars(t["out"], "train/lr") == _scalars(j["out"], "train/lr")
    # zero_eval: both splits scored before the first update, as in JAX
    for tag in ("zero_valid/overall_acc", "zero_test/overall_acc"):
        zero = _scalars(t["out"], tag)
        assert zero == _scalars(j["out"], tag) and set(zero) == {0}
    assert t["result"]["global_step"] == j["result"]["global_step"] == 3
    assert t["result"]["val"] == j["result"]["val"]
    assert t["result"]["test"] == j["result"]["test"]


def test_port_run_writes_snapshots_scalars_and_scores(runs):
    t = runs["port"]
    out = t["out"]
    losses = _scalars(out)
    assert len(losses) == 3 and all(np.isfinite(list(losses.values())))
    assert os.path.exists(os.path.join(out, "log", "args.json"))
    assert any(k.startswith("valid/") for k in
               {json.loads(line)["tag"] for line in
                open(os.path.join(out, "log", "scalars.jsonl"))})
    for split in ("val", "test"):
        assert "overall_acc" in t["result"][split]
        assert "what_acc" in t["result"][split]


def test_do_inference_restores_a_snapshot(runs, tmp_path):
    t = runs["port"]
    out = tmp_path / "out"
    shutil.copytree(t["out"], out)
    argv = ["--task", "msvd_qa", "--config", t["path"], "--output_dir",
            str(out), "--do_inference", "1"]
    inf = trun.main(argv + ["--inference_model_step", "3"])
    assert inf["val"] == t["result"]["val"] and inf["test"] == {}
    assert (out / "qa_results_val.json").exists()
    # the step-2 snapshot is another model: its answers come from it
    res2 = trun.main(argv + ["--inference_model_step", "2"])
    assert res2["global_step"] == 3
    with pytest.raises(FileNotFoundError, match="99"):
        trun.main(argv + ["--inference_model_step", "99"])


def test_preempt_and_resume_continue_the_trajectory(synth, tmp_path,
                                                     monkeypatch,
                                                     jax_init_weights):
    """SIGTERM during update 2 checkpoints at its boundary and returns; a
    second run resumes at micro 4 and its update 3 equals the uninterrupted
    run's.  Each micro holds every group (2 epochs of 4 groups an update),
    so the restarted data stream gives the same micros up to row order."""
    over = dict(train_batch_size=4, num_train_epochs=6)
    full = trun.start_training(_args(_cfg(synth, tmp_path / "full", **over),
                                     tmp_path / "full.json"))
    real = tsteps.make_scan_train_step
    calls = []

    def preempting(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, seed):
            calls.append(state.step)
            if len(calls) == 2:
                # the loop's SIGTERM handler, called as the signal would
                # call it (a real signal would take the worker down if
                # the handler were missing)
                handler = signal.getsignal(signal.SIGTERM)
                assert callable(handler), handler
                handler(signal.SIGTERM, None)
            return step(state, batch, seed)
        return wrapped

    out = tmp_path / "cut"
    with monkeypatch.context() as m:
        m.setattr(tsteps, "make_scan_train_step", preempting)
        first = trun.start_training(_args(_cfg(synth, out, **over),
                                          tmp_path / "cut.json"))
    assert first["preempted"] and first["global_step"] == 2
    assert calls == [0, 2]
    assert sorted(os.listdir(out / "restore")) == ["step_2.pt", "step_4.pt"]
    second = trun.start_training(_args(_cfg(synth, out, **over),
                                       tmp_path / "cut.json"))
    assert second["global_step"] == full["global_step"] == 3
    cut, ref = _scalars(str(out)), _scalars(str(tmp_path / "full"))
    assert sorted(cut) == [1, 2, 3]
    np.testing.assert_allclose([cut[s] for s in (1, 2, 3)],
                               [ref[s] for s in (1, 2, 3)], atol=ATOL,
                               rtol=RTOL)
    final_cut = torch.load(out / "ckpt" / "model_step_3.pt")
    final_ref = torch.load(tmp_path / "full" / "ckpt" / "model_step_3.pt")
    for name, val in final_ref.items():
        np.testing.assert_allclose(final_cut[name].numpy(), val.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    assert second["val"] == full["val"]


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-blip"])
def test_classifier_overfits_a_repeated_batch(synth, model):
    """The convergence gate (VERDICT.md): 40 adam updates on one repeated
    batch of the synthetic train split (8 questions, answers a function
    of the question) drive the classifier's CE loss below a tenth of its
    start and its train accuracy on the batch to 100%."""
    ds, _, a2l = _datasets(synth, "train", True)
    cfg = _cfg(synth, "unused", **_family_cfg(model))
    _, m = trun.build_model(dict(cfg, num_labels=len(a2l)), device="cpu")
    collator = tds.make_collator("clip", make_test_wordpiece(), cfg)
    batch = collator([ds.get_group(i) for i in range(len(ds))],
                     rng=np.random.default_rng(0))
    batch = {k: batch[k] for k in ("text_input_ids", "text_attention_mask",
                                   "visual_inputs", "labels")}
    state = tsteps.create_train_state(
        m, {"optim": "adam", "learning_rate": 1e-3, "decay": "constant"}, 40,
        device="cpu")
    step = tsteps.make_classifier_train_step(device="cpu")
    losses = []
    for _ in range(40):
        state, metrics = step(state, batch, 0)
        losses.append(metrics["loss"].item())
    assert losses[-1] < 0.1 * losses[0], losses
    assert int(metrics["acc_correct"]) == int(metrics["acc_total"]) == 8


def test_restore_refuses_another_layout(synth, tmp_path):
    from sasvqa_torch.core.checkpoint import (FormulationMismatchError,
                                              TrainingRestorer)
    from sasvqa_torch.models.presets import build_model
    states = []
    for vocab in (512, 300):
        _, model = build_model({"model": {"pretrained_model": "tiny-git",
                                          "vocab_size": vocab},
                                "img_size": 32}, device="cpu")
        states.append(tsteps.create_train_state(
            model, {"learning_rate": 1e-3}, 4, device="cpu"))
    TrainingRestorer(str(tmp_path), save_steps=1).force_save(3, states[0])
    with pytest.raises(FormulationMismatchError):
        TrainingRestorer(str(tmp_path)).restore_into(states[1])


def test_prefetcher_close_leaves_nothing_and_surfaces_errors():
    def source():
        for i in range(100):
            yield {"x": np.full((2,), i, np.float32), "question_ids": [i]}

    pf = tpipe.DevicePrefetcher(source(), depth=2, device="cpu")
    arrays, host = next(pf)
    assert host == {"question_ids": [0]} and arrays["x"].tolist() == [0, 0]
    pf.close()
    assert not pf._thread.is_alive() and pf._q.empty()

    def failing():
        yield {"x": np.zeros(1)}
        raise OSError("store went away")

    pf = tpipe.DevicePrefetcher(failing(), device="cpu")
    next(pf)
    with pytest.raises(OSError, match="store went away"):
        next(pf)
    pf.close()


def test_platform_unset_needs_a_gpu(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(synth, tmp_path / "out")
    del cfg["platform"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.start_training(_args(cfg, tmp_path / "c.json"))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("override,error,match", [
    # a mesh must have one device a process: [2] in one process names
    # the torchrun launch it needs
    ({"mesh_shape": [2]}, ValueError, "torchrun --nproc_per_node 2"),
    ({"remat": True, "remat_policy": "save_only_these_names"},
     NotImplementedError, "remat_policy"),
])
def test_unported_branches_raise(synth, tmp_path, override, error, match):
    cfg = dict(_cfg(synth, tmp_path / "out"), **override)
    with pytest.raises(error, match=match):
        trun.start_training(_args(cfg, tmp_path / "c.json"))
