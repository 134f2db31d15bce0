"""The synthetic fixtures, the quickstart and the profile tools of the port
on the CPU: the fixtures' stores (read with h5py) and annotation files are
byte-equal to the JAX package's, through the HDF5 writer and through an
in-memory writer; quickstart's config equals the JAX one for each family
and one port quickstart run trains to a finite loss; the profile_step and
profile_config probes run at tiny widths."""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from sasvqa_tpu.data import synthetic as jsyn
from sasvqa_tpu.tools import quickstart as jqs

from sasvqa_torch.data import synthetic as tsyn
from sasvqa_torch.tools import profile_config as pc
from sasvqa_torch.tools import profile_step as ps
from sasvqa_torch.tools import quickstart as tqs

FIXTURES = {
    "msvd_qa": ("make_synthetic_dataset",
                dict(task="msvd_qa", num_videos=3, stored_frames=5,
                     img_hw=16, questions_per_video=2, seed=4)),
    "msrvtt_qa": ("make_synthetic_dataset",
                  dict(task="msrvtt_qa", num_videos=2, stored_frames=4,
                       img_hw=8, with_sampled_inds=False)),
    "frameqa": ("make_synthetic_frameqa_dataset",
                dict(num_videos=3, stored_frames=4, img_hw=8)),
    "mc": ("make_synthetic_mc_dataset",
           dict(task="transition", num_videos=4, stored_frames=6, img_hw=8,
                n_options=3, seed=2)),
}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


class MemoryWriter:
    """FrameStoreWriter's interface over host memory."""
    stores = {}

    def __init__(self, path, num_videos, num_frames, img_hw):
        self.rows = np.zeros((num_videos, num_frames, 3 * img_hw * img_hw),
                             np.float32)
        MemoryWriter.stores[path] = self.rows

    def write(self, row, frames_chw):
        self.rows[row] = frames_chw.reshape(self.rows.shape[1], -1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_synthetic_fixtures_equal_jax(kind, tmp_path):
    fn, kw = FIXTURES[kind]
    want = getattr(jsyn, fn)(str(tmp_path / "jax"), **kw)
    got = getattr(tsyn, fn)(str(tmp_path / "port"), **kw)
    assert set(got) == set(want)
    for key in want:
        assert os.path.relpath(got[key], tmp_path / "port") == \
            os.path.relpath(want[key], tmp_path / "jax")
        if key == "h5":
            with h5py.File(want[key]) as a, h5py.File(got[key]) as b:
                assert list(a) == list(b) == ["sampled_frames"]
                da, db = a["sampled_frames"], b["sampled_frames"]
                assert da.dtype == db.dtype and da.shape == db.shape
                assert np.asarray(da).tobytes() == np.asarray(db).tobytes()
        else:
            assert _bytes(got[key]) == _bytes(want[key]), key
    # the writer seam: the same rows and files without h5py
    mem = getattr(tsyn, fn)(str(tmp_path / "mem"), writer=MemoryWriter,
                            **kw)
    assert not os.path.exists(mem["h5"])
    with h5py.File(want["h5"]) as a:
        assert MemoryWriter.stores[mem["h5"]].tobytes() == \
            np.asarray(a["sampled_frames"]).tobytes()
    for key in set(mem) - {"h5"}:
        assert _bytes(mem[key]) == _bytes(want[key])


@pytest.mark.parametrize("writer", ["h5", "memory"])
def test_make_scale_store_equals_jax(writer, tmp_path):
    """The scale store at a tiny size: the frame bytes, vidmapping and the
    three QA files equal the JAX tool's, through HDF5 and in memory."""
    from sasvqa_tpu.tools.make_scale_store import make_scale_store as jmake

    from sasvqa_torch.tools import make_scale_store as tmss
    kw = dict(num_videos=5, k=3, img_size=8, seed=3,
              n_questions={"train": 7, "val": 4, "test": 5})
    want = jmake(str(tmp_path / "jax"), **kw)
    argv = ["--root", str(tmp_path / "port"), "--num_videos", "5", "--k",
            "3", "--img_size", "8", "--seed", "3", "--train_q", "7",
            "--val_q", "4", "--test_q", "5"]
    if writer == "h5":
        assert tmss.main(argv) == 0
    else:
        assert tmss.main(argv, writer=MemoryWriter) == 0
    got = {k: str(tmp_path / "port" / os.path.basename(v))
           for k, v in want.items()}
    with h5py.File(want["h5"]) as a:
        rows = np.asarray(a["sampled_frames"])
    if writer == "h5":
        with h5py.File(got["h5"]) as b:
            assert np.asarray(b["sampled_frames"]).tobytes() == \
                rows.tobytes()
    else:
        assert not os.path.exists(got["h5"])
        assert MemoryWriter.stores[got["h5"]].tobytes() == rows.tobytes()
    for key in ("vidmapping", "train", "val", "test"):
        assert _bytes(got[key]) == _bytes(want[key]), key
    assert len(json.loads(_bytes(got["train"]))) == 7


def test_video_frames_equal_jax():
    for idx, n, hw, scenes in ((0, 9, 8, 3), (5, 4, 6, 1), (2, 30, 4, 5)):
        want = jsyn.make_video_frames(idx, n, hw, scenes)
        got = tsyn.make_video_frames(idx, n, hw, scenes)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("family,mesh,epochs", [
    ("clip", 1, 1), ("git", 1, 2), ("mc", 2, 3)])
def test_quickstart_config_equals_jax(family, mesh, epochs, tmp_path):
    paths = {k: f"/data/{k}" for k in ("train", "val", "test", "h5",
                                       "vidmapping")}
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = jqs.build_config(str(tmp_path / "j"), paths, family, mesh, epochs)
    got = tqs.build_config(str(tmp_path / "t"), paths, family, mesh, epochs,
                           platform="cpu")
    jcfg, tcfg = json.loads(_bytes(want)), json.loads(_bytes(got))
    assert jcfg.pop("output_dir") == str(tmp_path / "j" / "out")
    assert tcfg.pop("output_dir") == str(tmp_path / "t" / "out")
    assert tcfg == jcfg
    # without --platform the port's config asks for the GPU
    gpu = json.loads(_bytes(tqs.build_config(str(tmp_path / "t"), paths,
                                             family, mesh, epochs)))
    assert gpu["platform"] is None


def test_quickstart_git_runs_on_the_cpu(tmp_path):
    """``quickstart --family git --platform cpu`` end to end: a finite
    train loss after its updates, scalars.jsonl and a snapshot."""
    root = tmp_path / "qs"
    result = tqs.main(["--family", "git", "--platform", "cpu", "--root",
                       str(root)])
    assert result["global_step"] == 2
    assert np.isfinite(result["train_loss"])
    with open(root / "out" / "log" / "scalars.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert "train/loss" in tags
    assert "overall_acc" in result["val"]
    assert os.listdir(root / "out" / "ckpt")


def test_quickstart_mesh_raises(tmp_path):
    """--mesh 2 needs two processes: in one it raises the loop's error,
    which names the torchrun launch."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tqs.main(["--family", "clip", "--platform", "cpu", "--mesh", "2",
                  "--root", str(tmp_path)])


def test_quickstart_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqs.main(["--family", "git", "--root", str(tmp_path)])


TINY_GIT = ps.GitShape("tiny-git", batch=2, frames=2, text_len=8)


def _check_rows(rows, names):
    assert [r["probe"] for r in rows] == list(names)
    for r in rows:
        assert r["device"] == "cpu" and np.isfinite(r["ms"]) and r["ms"] > 0
        assert "peak_share" not in r   # a device metric: not on the CPU


def test_profile_step_probes_run_tiny():
    rows = ps.run(TINY_GIT, iters=1, device="cpu")
    _check_rows(rows, ps.PROBES)
    step = rows[0]
    assert step["tflop"] == pytest.approx(ps.step_flop(TINY_GIT) / 1e12)
    assert rows[[r["probe"] for r in rows].index("adamw")]["params"] > 0
    assert ps.FLAGSHIP.seq == 1608


def test_profile_config_probes_run_tiny():
    clip = pc.clip1(1, "cpu", shape=pc.ClipShape("tiny-clip", 2, 2, 8,
                                                  num_labels=5))
    _check_rows(clip, ("step", "vis_tower", "txt_tower", "fusion", "adamw"))
    _check_rows(pc.mif2(1, "cpu", shape=TINY_GIT),
                ("step", "vis_tower", "txt_stack", "logits", "adamw"))
    assert (pc.MIF2.seq, pc.VITL16.seq) == (426, 4144)


def test_remat_sweep_runs_tiny():
    """Every policy of the sweep trains the same first update: the same
    loss from the same weights, batch and dropout draws."""
    rows = pc.vitl16(2, "cpu", shape=ps.GitShape("tiny-git", 2, 2, 8,
                                                  remat=True))
    sweep = [r for r in rows if r["probe"] == "remat_update"]
    assert [r["policy"] for r in sweep] == [p[0] for p in pc.REMAT_SWEEP]
    assert len({r["first_loss"] for r in sweep}) == 1
    assert np.isfinite(sweep[0]["first_loss"])
    _check_rows(rows[len(sweep):], ("txt_flash", "txt_stack", "adamw"))


def test_remat_row_hands_over_the_warmup_gradients():
    """``remat_row``'s ``warmed`` sees the warm-up update's gradients: the
    same under full recompute and under a named policy (the same weights,
    batch and dropout draws), none of them zero; the row counts no kernel
    launch on the CPU."""
    grads = {}
    for policy in (None, "dots_saveable"):
        grads[policy] = {}
        shape = ps.GitShape("tiny-git", 2, 2, 8, remat=True,
                            remat_policy=policy)
        row = pc.remat_row(
            str(policy), shape, 1, torch.device("cpu"),
            warmed=lambda m, g=grads[policy]: g.update(
                (n, p.grad.clone()) for n, p in m.named_parameters()))
        assert row["launches"] == {} and np.isfinite(row["first_loss"])
        assert row["batch"] == shape.batch and "error" not in row
    assert set(grads[None]) == set(grads["dots_saveable"])
    for name, g in grads[None].items():
        torch.testing.assert_close(grads["dots_saveable"][name], g,
                                   atol=0, rtol=0, msg=name)
    tower = [g for name, g in grads[None].items()
             if name.startswith("image_encoder.layers_")]
    assert tower and all(g.abs().sum() > 0 for g in tower)
