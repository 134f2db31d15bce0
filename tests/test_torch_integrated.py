"""The port's integrated run (``sasvqa_torch.tools.integrated_run``) vs the
JAX tool at the repo root (``integrated_run.py``), on the CPU at tiny
size: both read ``configs/msvd_qa_base.json`` from the working directory,
here the shipped file with a ``tiny-git`` model block (dropouts off), f32,
one device and a batch of 2 x 2 micros, over a 4-video store at the shipped 224x224
frames.  The port's model starts from the JAX loop's init.  The reports
have the same keys, steps, batch and eval counts and the same train loss;
the stores are byte-equal.  Also: the steady-window arithmetic on a
written log, the log the tool reads, the in-memory store pair, and the
device rule."""

import json
import math
import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sasvqa_tpu.core import logging as jlogging
from sasvqa_tpu.core.config import ConfigDict as JConfigDict
from sasvqa_tpu.models import presets as jpresets

from sasvqa_torch.core import logging as tlogging
from sasvqa_torch.data.frame_store import FrameStoreReader, MemoryFrameStores
from sasvqa_torch.tasks import run_video_qa as trun
from sasvqa_torch.tools import integrated_run as tir
from sasvqa_torch.tools.make_scale_store import make_scale_store

from _torch_parity import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX-vs-port loops' per-update losses (tests/test_torch_task_loop.py)
LOSS_TOL = 1e-5
# 40 questions at a global batch of 4: 30 updates in 3 epochs, marks at
# steps 10, 20, 30, one in-loop validation (step 20) and the final one
ARGV = ["--platform", "cpu", "--num_videos", "4", "--train_q", "40",
        "--val_q", "10", "--steps", "30", "--val_limit", "4"]
BASE_KEYS = {"config", "global_steps", "global_batch_qa", "wall_s",
             "train_loss"}
STEADY_KEYS = {"steady_steps_per_s", "steady_qa_pairs_per_s",
               "steady_ms_per_micro", "first_window_s"}
EVAL_TAGS = ("valid", "test", "final_valid", "final_test")


def _tiny_config():
    """The shipped config with the tiny model and batch of the test."""
    with open(os.path.join(REPO, "configs", "msvd_qa_base.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(pretrained_model="tiny-git", vocab_size=512,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    # one device: the JAX suite's 8 virtual CPU devices would multiply
    # the JAX loop's global batch
    cfg.update(bf16=0, train_batch_size=2, gradient_accumulation_steps=2,
               val_batch_size=4, gen_max_new_tokens=4, mesh_shape=[1])
    return cfg


def _jax_init(cfg):
    """The params the JAX loop initialises from cfg.seed."""
    _, jm = jpresets.build_model(JConfigDict(cfg), dtype=jnp.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    img = cfg["img_size"]
    return jax.jit(jm.init)(jax.random.key(cfg["seed"]), ids, ids,
                            jnp.zeros((1, 1, img, img, 3)))


def _losses(out):
    with open(os.path.join(out, "run", "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "train/loss"}


def _eval_counts(out):
    with open(os.path.join(out, "run", "log", "log.txt")) as f:
        return [(tag, n) for tag, n, _ in tir.read_log(f)[1]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both tools once, in a working directory holding the tiny config."""
    root = tmp_path_factory.mktemp("integrated")
    (root / "configs").mkdir()
    cfg = _tiny_config()
    with open(root / "configs" / "msvd_qa_base.json", "w") as f:
        json.dump(cfg, f)
    params = _jax_init(cfg)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(REPO)
        mp.chdir(root)
        import integrated_run as jir
        real = trun.build_model
        mp.setattr(trun, "build_model", lambda c, **kw: (
            lambda fm: (fm[0], load_flax_params(fm[1], params)))(
                real(c, **kw)))
        for pkg, main in (("jax", jir.main), ("port", tir.main)):
            # each run starts as in a fresh process: the scalar logger's
            # step is process-wide in both packages
            jlogging.TB_LOGGER.global_step = 0
            tlogging.TB_LOGGER.global_step = 0
            report = main(ARGV + ["--root", str(root / pkg / "store"),
                                  "--out", str(root / pkg / "out")])
            out[pkg] = {"report": report, "root": root / pkg}
    return out


def test_reports_match_jax(runs):
    """The same keys (the steady rates, or the note when the in-loop
    evals fill the window: wall time decides which), steps, batch, eval
    counts, per-update losses and final train loss."""
    reports = {pkg: r["report"] for pkg, r in runs.items()}
    for report in reports.values():
        eval_keys = {f"eval_{t}_{k}" for t in EVAL_TAGS
                     for k in ("s", "qa_per_s")}
        steady = STEADY_KEYS if "steady_steps_per_s" in report \
            else {"steady_window_note"}
        assert set(report) == BASE_KEYS | eval_keys | steady, report
        assert report["config"] == "integrated_msvd_qa_base"
    want, got = reports["jax"], reports["port"]
    assert got["global_steps"] == want["global_steps"] == 30
    assert got["global_batch_qa"] == want["global_batch_qa"] == 4
    counts = {pkg: _eval_counts(r["root"] / "out")
              for pkg, r in runs.items()}
    assert counts["port"] == counts["jax"] == [(t, 4) for t in EVAL_TAGS]
    jl, tl = (_losses(runs[pkg]["root"] / "out") for pkg in ("jax", "port"))
    assert sorted(tl) == sorted(jl) == list(range(1, 31))
    np.testing.assert_allclose([tl[s] for s in sorted(tl)],
                               [jl[s] for s in sorted(jl)],
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    assert math.isfinite(got["train_loss"])
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    # the run wrote its snapshots and restore checkpoints
    run = runs["port"]["root"] / "out" / "run"
    assert os.listdir(run / "ckpt") and os.listdir(run / "restore")


def test_stores_equal_jax(runs):
    """The store, the vidmapping, the annotations and their val/test
    cuts are byte-equal to the JAX tool's."""
    def read(path):
        with open(path, "rb") as f:
            return f.read()

    jroot, troot = runs["jax"]["root"], runs["port"]["root"]
    store = os.path.join("store", "main_k6")
    with h5py.File(jroot / store / "msvd_qa_video_feat.h5") as a, \
            h5py.File(troot / store / "msvd_qa_video_feat.h5") as b:
        want = np.asarray(a["sampled_frames"])
        assert want.shape == (4, 6, 3 * 224 * 224)
        assert np.asarray(b["sampled_frames"]).tobytes() == want.tobytes()
    for name in ("vidmapping.json", "qa_train.json", "qa_val.json",
                 "qa_test.json"):
        assert read(troot / store / name) == read(jroot / store / name)
    for split in ("val", "test"):
        name = os.path.join("out", f"qa_{split}_limit.json")
        assert read(troot / name) == read(jroot / name)
        assert len(json.loads(read(troot / name))) == 4


def _log_line(msg):
    return f"10/17/2026 12:00:00 - INFO - sasvqa_torch -   {msg}\n"


def _write_log(path, marks, evals):
    lines = [_log_line(f"step {s}/30 train_loss: 6.2000 acc 0.00 ({t}s)")
             for s, t in marks]
    lines[1:1] = [_log_line(f"[{tag}] {n} examples in {w:.1f}s: "
                            "{'overall_acc': 0.0}") for tag, n, w in evals]
    with open(path, "w") as f:
        f.writelines(lines)


@pytest.mark.parametrize("walls,want", [
    # 28 s between the marks less the in-loop 3.5 + 2.5 s: 20 updates in
    # 22 s; the final validations, after the last mark, are not taken off
    ((3.5, 2.5), {"steady_steps_per_s": round(20 / 22, 4),
                  "steady_qa_pairs_per_s": round(20 * 432 / 22, 1),
                  "steady_ms_per_micro": round(1000 * 22 / (20 * 72), 2),
                  "first_window_s": 12}),
    # in-loop validations longer than the window: a note, no rates
    ((20.0, 9.0), {"steady_window_note": (
        "in-loop eval walls exceed the step-mark window; rerun with more "
        "--steps or --val_limit")}),
])
def test_steady_window_on_a_written_log(walls, want, tmp_path):
    evals = [("valid", 64, walls[0]), ("test", 64, walls[1]),
             ("final_valid", 64, 1.6), ("final_test", 64, 3.2)]
    path = tmp_path / "log.txt"
    _write_log(path, [(10, 12), (20, 30), (30, 40)], evals)
    with open(path) as f:
        marks, val_walls = tir.read_log(f)
    assert marks == [(10, 12), (20, 30), (30, 40)]
    assert val_walls == evals
    report = tir.window_report(marks, val_walls, 432, 72)
    for tag, n, w in evals:
        want[f"eval_{tag}_s"] = w
        want[f"eval_{tag}_qa_per_s"] = round(n / w, 1)
    assert report == want


def test_reads_only_this_runs_log_txt(tmp_path, monkeypatch):
    """The report reads rank 0's log.txt, not another rank's log in the
    same directory, and only the lines of its own run when a second run
    appends to the same --out."""
    calls = []

    def fake_loop(argv, open_store):
        with open(argv[-1]) as f:
            cfg = json.load(f)
        log = os.path.join(cfg["output_dir"], "log")
        os.makedirs(log, exist_ok=True)
        calls.append(cfg)
        scale = len(calls)      # each run's marks at its own pace
        with open(os.path.join(log, "log.host1.txt"), "w") as f:
            f.write(_log_line("step 10/30 x (1s)"))
        with open(os.path.join(log, "log.txt"), "a") as f:
            for s in (10, 20, 30):
                f.write(_log_line(f"step {s}/30 x ({s * scale}s)"))
        return {"global_step": 30, "train_loss": 1.5}

    monkeypatch.setattr(trun, "main", fake_loop)
    monkeypatch.chdir(REPO)
    stores = MemoryFrameStores()
    argv = ["--platform", "cpu", "--num_videos", "2", "--train_q", "4",
            "--val_q", "2", "--root", str(tmp_path / "s"), "--out",
            str(tmp_path / "o")]
    first = tir.main(argv, writer=stores.writer,
                     open_store=stores.open_store)
    second = tir.main(argv, writer=stores.writer,
                      open_store=stores.open_store)
    assert first["first_window_s"] == 10 and second["first_window_s"] == 20
    assert first["steady_steps_per_s"] == 1.0
    assert second["steady_steps_per_s"] == 0.5
    assert calls[0]["stage_pixels_u8"] == 0 and calls[0]["platform"] == "cpu"
    assert not os.path.exists(tmp_path / "s" / "main_k6" /
                              "msvd_qa_video_feat.h5")


def test_memory_stores_read_as_hdf5(tmp_path):
    """MemoryFrameStores written by make_scale_store read back the HDF5
    store's frames (unsorted and repeated indices too)."""
    kw = dict(num_videos=3, k=4, img_size=8, seed=2,
              n_questions={"train": 3, "val": 2, "test": 2})
    h5 = make_scale_store(str(tmp_path / "h5"), **kw)["h5"]
    stores = MemoryFrameStores()
    mem = make_scale_store(str(tmp_path / "mem"), writer=stores.writer,
                           **kw)["h5"]
    want, got = FrameStoreReader(h5), stores.open_store(mem)
    assert got.shape == want.shape == (3, 4, 3 * 8 * 8)
    for row, inds in ((0, [0, 1, 2, 3]), (2, [3, 0, 3]), (1, [2])):
        a = want.read_frames_nhwc(row, inds)
        b = got.read_frames_nhwc(row, inds)
        assert b.dtype == a.dtype and b.shape == a.shape == (len(inds), 8,
                                                             8, 3)
        assert b.tobytes() == a.tobytes()
    want.close()


def test_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    """Without a GPU and without --platform cpu it raises before it
    builds the store."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tir.main(["--root", str(tmp_path / "s"), "--out",
                  str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "s")
