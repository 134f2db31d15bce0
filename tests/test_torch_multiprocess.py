"""Multi-process training and validation of the port on the CPU: real
gloo process groups of 2 and 4 ranks (``tests/_torch_mp_worker.py``
subprocesses on a ``file://`` store, each with a group timeout and a
subprocess timeout) running ``run_video_qa.main`` (the counterparts of
tests/test_multihost_{train,eval}.py):

(a) data parallelism: a 2-rank ``data`` run of tiny-git and of tiny-clip
    matches a 1-rank run over the same global batches (the losses of
    every update and the final snapshot), and tiny-git also matches the
    JAX ``start_training`` at ``mesh_shape [2]``; the fixture's questions
    give the ranks unequal counts of loss targets, so that a rank-local
    mean would fail;
(b) resume: a second 2-rank invocation resumes the restore snapshot in
    lockstep, one rank resumes a 2-rank snapshot and 2 ranks a 1-rank
    one;
(c) FSDP: a 4-rank (data 2, fsdp 2) run matches the 1-rank run, and its
    validation over a padded batch plan gives the 1-rank scores;
(d) tensor parallelism on GIT: 2 ``model`` ranks give the unsharded loss
    and gradients (fused qkv, vocabulary-sharded LM head), and with
    dropout on the replicated leaves stay bit-equal on both ranks;
(e) 'random'-policy validation scores are equal at 1 and 2 ranks;
and quickstart ``--mesh 2`` on two ranks.

Dropout is off in every run but (d)'s second half.  All runs start in
one module fixture, several at once."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sasvqa_tpu.core import logging as jlogging
from sasvqa_tpu.core.checkpoint import ModelSaver as JSaver
from sasvqa_tpu.core.config import get_video_qa_args as jget_args
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.core.config import ConfigDict as JConfigDict
from sasvqa_tpu.tasks import run_video_qa as jrun

from sasvqa_torch.core import logging as tlogging
from sasvqa_torch.core.config import get_video_qa_args
from sasvqa_torch.data import pipeline as tpipe
from sasvqa_torch.data.synthetic import make_synthetic_dataset
from sasvqa_torch.models.presets import build_model
from sasvqa_torch.parallel import mesh as tmesh
from sasvqa_torch.tasks import run_video_qa as trun

from _torch_parity import load_flax_params

ATOL = 2e-5
WORKER = os.path.join(os.path.dirname(__file__), "_torch_mp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a group that waits this long on a peer fails instead of hanging
TIMEOUT_S = 420


def _vary_lengths(paths):
    """Train questions of 5 to 8 words: the GIT collator supervises every
    position after the question (padding included), so the rows of a
    batch hold unequal numbers of loss targets."""
    with open(paths["train"]) as f:
        annos = json.load(f)
    extra = ["", "very ", "very big old "]
    for i, a in enumerate(annos):
        a["question"] = a["question"].replace(" the ", f" the {extra[i % 3]}")
    with open(paths["train"], "w") as f:
        json.dump(annos, f)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_synth")
    paths = make_synthetic_dataset(str(root), num_videos=4, stored_frames=8,
                                   img_hw=32, questions_per_video=2)
    _vary_lengths(paths)
    return paths


def _cfg(paths, out, model="tiny-git", **over):
    """3 updates of 2 micros of a global batch of 4 groups (the caller
    sets train_batch_size = 4 / ranks), f32, dropouts off, then the final
    validation.  vocab 2048: the embeddings and the LM head reach FSDP's
    2^16-element floor.  SGD, as the JAX package's layout tests use it:
    Adam's g/|g| turns the reduction-order noise of a gradient that is
    zero in exact arithmetic (the key bias of softmax attention) into
    steps of the learning rate; the tensor-parallel job trains with
    AdamW."""
    cfg = {
        "task": "msvd_qa",
        "train_datasets": [{"name": "msvd_qa", "txt": paths["train"],
                            "img": paths["h5"]}],
        "val_datasets": [{"name": "msvd_qa", "txt": paths["val"],
                          "img": paths["h5"]}],
        "inference_txt_db": paths["test"], "inference_img_db": paths["h5"],
        "vid_mapping": paths["vidmapping"],
        "model": {"pretrained_model": model, "vocab_size": 2048,
                  "hidden_dropout_prob": 0.0,
                  "attention_probs_dropout_prob": 0.0},
        "img_size": 32, "nframe": 2, "samp_policy": "uniform",
        "max_n_example_per_group": 1, "train_batch_size": 4,
        "val_batch_size": 4, "inference_batch_size": 4,
        "gradient_accumulation_steps": 2, "num_train_epochs": 3,
        "min_valid_steps": 2, "num_valid": 1, "learning_rate": 0.1,
        "decay": "constant", "optim": "sgd", "seed": 0,
        "platform": "cpu", "bf16": 0, "output_dir": str(out),
        "max_txt_len": 16, "gen_max_text_len": 24, "gen_max_new_tokens": 4}
    cfg.update(over)
    path = f"{out}.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return ["--task", "msvd_qa", "--config", path]


class _Group:
    """``world`` worker processes running one job, started at once."""

    def __init__(self, job, world, root, tag):
        self.dir = os.path.join(root, tag)
        os.makedirs(self.dir)
        job_path = os.path.join(self.dir, "job.json")
        with open(job_path, "w") as f:
            json.dump(job, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.environ.get("PYTHONPATH", "")]))
        self.outs = [os.path.join(self.dir, f"out{r}.json")
                     for r in range(world)]
        store = os.path.join(self.dir, "store")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), store, job_path,
             self.outs[r]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]

    def results(self):
        try:
            logs = [p.communicate(timeout=TIMEOUT_S + 60)[0].decode()
                    for p in self.procs]
        finally:
            for p in self.procs:
                p.kill()
        for p, log in zip(self.procs, logs):
            assert p.returncode == 0, log[-4000:]
        out = []
        for path in self.outs:
            with open(path) as f:
                out.append(json.load(f))
        return out


def _scalars(out, tag="train/loss"):
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def _snapshot(out, step):
    return torch.load(os.path.join(out, "ckpt", f"model_step_{step}.pt"),
                      weights_only=True)


def _one_rank(argv, init=None):
    """run_video_qa.main in this process (no process group), starting
    from the state dict ``init`` when given."""
    tlogging.TB_LOGGER.global_step = 0
    if init is None:
        return trun.main(argv)
    mp = pytest.MonkeyPatch()
    real = trun.build_model

    def build(cfg, **kw):
        family, model = real(cfg, **kw)
        model.load_state_dict(init)
        return family, model

    mp.setattr(trun, "build_model", build)
    try:
        return trun.main(argv)
    finally:
        mp.undo()


def _jax_init(args):
    _, jm = jpresets.build_model(JConfigDict(args), dtype=jnp.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    return jax.jit(jm.init)(jax.random.key(args["seed"]), ids, ids,
                            jnp.zeros((1, 1, 32, 32, 3)))


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mp_runs"))
    at = lambda name: os.path.join(root, name)          # noqa: E731
    # every tiny-git run starts from the JAX loop's init
    git_args = get_video_qa_args(_cfg(synth, at("probe")))
    jinit = _jax_init(git_args.to_dict())
    init = build_model(git_args, device="cpu")[1]
    init = {k: v.clone() for k, v in
            load_flax_params(init, jinit).state_dict().items()}
    torch.save(init, at("init.pt"))

    first = {
        "dp": _Group({"kind": "main", "init": at("init.pt"),
                      "argv": _cfg(synth, at("dp"), train_batch_size=2)},
                     2, root, "g_dp"),
        "dp_clip": _Group({"kind": "main", "argv": _cfg(
            synth, at("dp_clip"), "tiny-clip", train_batch_size=2)},
            2, root, "g_dp_clip"),
        "tp": _Group({"kind": "tp_grads", "vocab_size": 2048}, 2, root,
                     "g_tp"),
        "rand": _Group({"kind": "main", "argv": _cfg(
            synth, at("rand"), samp_policy="random", do_inference=1,
            val_batch_size=5)}, 2, root, "g_rand"),
    }
    res = {"at": at, "git_args": git_args}
    res["one"] = _one_rank(_cfg(synth, at("one")), init)
    res["one_clip"] = _one_rank(_cfg(synth, at("one_clip"), "tiny-clip"))
    res["one_rand"] = _one_rank(_cfg(synth, at("one_rand"),
                                     samp_policy="random", do_inference=1))
    # the JAX loop on 2 of the harness's 8 virtual CPU devices
    jlogging.TB_LOGGER.global_step = 0
    res["jax"] = jrun.start_training(jget_args(_cfg(
        synth, at("jax"), train_batch_size=2, mesh_shape=[2])))
    for name, group in first.items():
        res[name] = group.results()
    res["dp_losses"] = _scalars(at("dp"))    # before the resume appends

    # (b) and (c): resume the 2-rank run in 2 ranks and in 1 (a copy),
    # the 4-rank FSDP run, quickstart on 2 ranks
    shutil.copytree(at("dp"), at("dp_in_one"))
    shutil.copytree(at("one"), at("one_in_two"))
    more = ["--num_train_epochs", "5"]
    second = {
        "in_two": _Group({"kind": "main", "argv": _cfg(
            synth, at("one_in_two"), train_batch_size=2) + more}, 2, root,
            "g_in_two"),
        "resume": _Group({"kind": "main", "argv": _cfg(
            synth, at("dp"), train_batch_size=2) + more}, 2, root,
            "g_resume"),
        "fsdp": _Group({"kind": "main", "init": at("init.pt"),
                        "argv": _cfg(synth, at("fsdp"), train_batch_size=1,
                                     mesh_shape=[2, 2],
                                     mesh_axes=["data", "fsdp"],
                                     val_batch_size=10)},
                       4, root, "g_fsdp"),
        "quickstart": _Group({"kind": "quickstart", "argv": [
            "--family", "clip", "--platform", "cpu", "--mesh", "2",
            "--root", at("quickstart")]}, 2, root, "g_qs"),
    }
    res["in_one"] = _one_rank(_cfg(synth, at("dp_in_one")) + more)
    for name, group in second.items():
        res[name] = group.results()
    return res


def _same_on_every_rank(results):
    for r in results[1:]:
        assert r == results[0]


def test_ranks_hold_unequal_target_counts(synth):
    """The first global batches split over 2 ranks give the ranks
    different numbers of GIT loss targets (labels other than -100)."""
    cfg = get_video_qa_args(_cfg(synth, os.path.join(
        os.path.dirname(synth["train"]), "count")))
    ans2label = trun.build_common_answer_dict((cfg.train_datasets[0].txt,),
                                              1000)
    train_ds = trun.setup_datasets(cfg, ans2label)[0]
    collator = trun.make_collator("git", trun.build_tokenizer(cfg, "git"),
                                  cfg)
    layout = tmesh.MeshLayout((2,), ("data",))
    counts = []
    for r in range(2):
        pos = tmesh.host_batch_positions(layout, 4, r)
        it = tpipe.epoch_batches(train_ds, collator, 2, True,
                                 np.random.default_rng(0), drop_last=True,
                                 host_positions=pos, global_batch=4)
        counts.append([int((np.asarray(b["labels"])[:, 1:] != -100).sum())
                       for b in it])
    assert counts[0] != counts[1], counts


@pytest.mark.parametrize("family", ["tiny-git", "tiny-clip"])
def test_data_parallel_matches_one_process(runs, family):
    at = runs["at"]
    dp, one = ("dp", "one") if family == "tiny-git" else ("dp_clip",
                                                          "one_clip")
    _same_on_every_rank(runs[dp])
    assert runs[dp][0]["global_step"] == runs[one]["global_step"] == 3
    assert runs[dp][0]["val"] == runs[one]["val"]
    got = runs["dp_losses"] if dp == "dp" else _scalars(at(dp))
    want = _scalars(at(one))
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=ATOL)
    a, b = _snapshot(at(dp), 3), _snapshot(at(one), 3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    # rank 0 alone writes the scalars and log.txt; rank 1 its own log
    logs = sorted(os.listdir(os.path.join(at(dp), "log")))
    assert "log.txt" in logs and "log.host1.txt" in logs


def test_data_parallel_matches_jax(runs):
    """The JAX loop at mesh_shape [2] from the same init: every update's
    loss and the final snapshot."""
    at = runs["at"]
    got = runs["dp_losses"]
    want = _scalars(at("jax"))
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=ATOL)
    assert runs["jax"]["global_step"] == 3
    saver = JSaver(os.path.join(at("jax"), "ckpt"))
    try:
        jparams = saver.restore(3)
    finally:
        saver.close()
    want = load_flax_params(build_model(runs["git_args"], device="cpu")[1],
                            jparams).state_dict()
    got = _snapshot(at("dp"), 3)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)


def test_two_rank_resume_stays_in_lockstep(runs):
    at = runs["at"]
    res = runs["resume"]
    _same_on_every_rank(res)
    assert res[0]["global_step"] == 5
    steps = [s for s, _ in _scalars(at("dp"))]
    assert steps == [1, 2, 3, 4, 5]
    a, b = _snapshot(at("dp"), 3), _snapshot(at("dp"), 5)
    assert any(not torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("run,out", [("in_one", "dp_in_one"),
                                     ("in_two", "one_in_two")])
def test_resume_at_another_rank_count(runs, run, out):
    """A 2-rank restore snapshot resumed by one process, and a 1-process
    one by 2 ranks, over the same global batches, continue as the 2-rank
    resume does."""
    at = runs["at"]
    res = runs[run] if run == "in_one" else runs[run][0]
    if run == "in_two":
        _same_on_every_rank(runs[run])
    assert res["global_step"] == 5
    got, want = _scalars(at(out)), _scalars(at("dp"))
    assert [s for s, _ in got] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=ATOL)


def test_fsdp_matches_one_process(runs):
    at = runs["at"]
    res = runs["fsdp"]
    _same_on_every_rank(res)
    assert res[0]["global_step"] == 3
    got, want = _scalars(at("fsdp")), _scalars(at("one"))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=ATOL)
    a, b = _snapshot(at("fsdp"), 3), _snapshot(at("one"), 3)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    # validation over a padded plan (8 groups, global batch 12) scores as
    # one process does (batch 4)
    assert res[0]["val"] == runs["one"]["val"]
    assert res[0]["test"] == runs["one"]["test"]
    with open(os.path.join(at("fsdp"), "log", "log.txt")) as f:
        log = f.read()
    assert "[final_valid] 8 examples" in log


def test_tensor_parallel_git_matches_unsharded(runs):
    res = runs["tp"]
    for r in res:
        assert abs(r["loss_tp"] - r["loss_ref"]) < ATOL
        assert r["grad_err"] < ATOL
        # tiny-git: 4 heads of 8 -> 2 local heads; qkv rows 3*32/2
        assert r["heads"] == 2 and r["qkv_local_shape"] == [48, 32]
        assert r["n_sharded"] > 20
        assert r["refused"] == [True, True]
    # dropout on: the same masks on both model ranks, so that every
    # replicated leaf is bit-equal after two updates
    assert res[0]["drop_losses"] == res[1]["drop_losses"]
    assert res[0]["replicated"] == res[1]["replicated"]
    assert len(res[0]["replicated"]) > 20


def test_random_policy_validation_equal_at_one_and_two_ranks(runs):
    at = runs["at"]
    _same_on_every_rank(runs["rand"])
    assert runs["rand"][0]["val"] == runs["one_rand"]["val"]
    with open(os.path.join(at("rand"), "qa_results_val.json")) as f:
        two = json.load(f)
    with open(os.path.join(at("one_rand"), "qa_results_val.json")) as f:
        one = json.load(f)
    assert two == one and len(one) == 8


def test_quickstart_on_two_ranks(runs):
    res = runs["quickstart"]
    _same_on_every_rank(res)
    assert res[0]["global_step"] >= 1 and np.isfinite(res[0]["train_loss"])
    assert "overall_acc" in res[0]["val"]
