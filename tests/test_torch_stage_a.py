"""Stage A of the port (data/video_decode, sampling/mdf,
tools/extract_frames) against the JAX package on the same videos,
features and flags.

Tolerances: decoded frames, geometry, index arithmetic, stores and
vidmappings are equal (bit for bit); ``lcl`` within 1e-5 (f32 banded
sums); MDF picks and the exhausted flag equal on shared features; the two
bf16 vision towers' pooled features within 0.1 absolute (bf16 rounding
through 12 full-width layers), their picks each equal to their own
oracle's.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from sasvqa_tpu.data import video_decode as jvd
from sasvqa_tpu.data.frame_store import FrameStoreReader as JReader
from sasvqa_tpu.sampling import mdf as jmdf
from sasvqa_tpu.tools import extract_frames as jext

from sasvqa_torch.data import video_decode as tvd
from sasvqa_torch.data.frame_store import FrameStoreReader
from sasvqa_torch.sampling import mdf as tmdf
from sasvqa_torch.tools import extract_frames as text

from _torch_parity import numpy_tree
from _torch_video import write_raw_avi

POOLED_ATOL = 0.1


# ---- decoding --------------------------------------------------------------


@pytest.fixture(scope="module")
def mjpg_path(tmp_path_factory):
    """tests/test_video_decode.py's video: 30 frames of 64x48, 10 fps."""
    path = str(tmp_path_factory.mktemp("vid") / "test.avi")
    w, h, n = 64, 48, 30
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (w, h))
    for t in range(n):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[:, :, 0] = int(255 * t / n)
        frame[:, :, 2] = 255 - int(255 * t / n)
        writer.write(frame)
    writer.release()
    return path


def _forced_cv2(mod, path):
    dec = mod.VideoDecoder.__new__(mod.VideoDecoder)
    dec.path = path
    dec._h = None
    return dec


def test_decoder_equals_jax_decoder(mjpg_path):
    assert tvd.native_available() and jvd.native_available()
    for kw in ({}, {"interval": 2}, {"interval": 3, "out_size": (32, 32)}):
        np.testing.assert_array_equal(tvd.decode_video(mjpg_path, **kw),
                                      jvd.decode_video(mjpg_path, **kw))
    with tvd.VideoDecoder(mjpg_path) as t, jvd.VideoDecoder(mjpg_path) as j:
        assert t.info() == j.info() and t.info()[:2] == (64, 48)
        for kw in ({"chunk": 7}, {"interval": 3, "chunk": 4},
                   {"chunk": 4, "max_frames": 9}):
            got, want = list(t.iter_frames(**kw)), list(j.iter_frames(**kw))
            assert [len(c) for c in got] == [len(c) for c in want]
            np.testing.assert_array_equal(np.concatenate(got),
                                          np.concatenate(want))
        np.testing.assert_array_equal(t.read_window(1.0, 2.0),
                                      j.read_window(1.0, 2.0))
        np.testing.assert_array_equal(t.read_window(0.5, 1.5, interval=2),
                                      j.read_window(0.5, 1.5, interval=2))
        assert t._cap_rows(1, 4096) == j._cap_rows(1, 4096)


def test_cv2_fallback_equals_jax_fallback(mjpg_path):
    t, j = _forced_cv2(tvd, mjpg_path), _forced_cv2(jvd, mjpg_path)
    assert t.info() == j.info()
    np.testing.assert_array_equal(t._cv2_read(2, 4096, (64, 48)),
                                  j._cv2_read(2, 4096, (64, 48)))
    np.testing.assert_array_equal(t.read_window(1.0, 2.0),
                                  j.read_window(1.0, 2.0))
    assert t.read_window(50.0, 60.0).shape == (0, 48, 64, 3)
    np.testing.assert_array_equal(
        np.concatenate(list(t.iter_frames(chunk=7))),
        np.concatenate(list(j.iter_frames(chunk=7))))


def test_raw_avi_decodes_exactly_through_the_shim(tmp_path):
    """tests/_torch_video.py's uncompressed AVI round-trips bit for bit
    through the shim (and through cv2), odd widths included."""
    rng = np.random.default_rng(0)
    for h, w in ((24, 32), (30, 42)):
        frames = rng.integers(0, 256, (7, h, w, 3), dtype=np.uint8)
        path = write_raw_avi(str(tmp_path / f"raw{w}.avi"), frames)
        with tvd.VideoDecoder(path) as dec:
            assert dec._h and dec.info() == (w, h, 10.0, 7)
            np.testing.assert_array_equal(
                np.concatenate(list(dec.iter_frames(chunk=3))), frames)
        np.testing.assert_array_equal(
            _forced_cv2(tvd, path)._cv2_read(1, 4096, (w, h)), frames)


def test_no_shim_and_no_cv2_names_both(monkeypatch, mjpg_path):
    monkeypatch.setattr(tvd, "_load_lib", lambda: (None, "no libav here"))

    def no_cv2():
        raise ImportError("No module named 'cv2'")

    monkeypatch.setattr(tvd, "_import_cv2", no_cv2)
    with pytest.raises(IOError, match="no libav here") as err:
        tvd.VideoDecoder(mjpg_path)
    assert "cv2" in str(err.value)


# ---- MDF on shared features ------------------------------------------------


def _lcl_numpy(feats, w):
    f = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    sims = f @ f.T
    lcl = np.zeros(len(f))
    for i in range(w, len(f) - w):
        lcl[i] = (sims[i][i - w:i + w].sum() - 1) / (2 * w - 1)
    return lcl


@pytest.mark.parametrize("n,w", [(64, 4), (100, 5), (30, 3)])
def test_local_average_similarity(n, w):
    feats = np.random.default_rng(0).normal(size=(n, 16)).astype(np.float32)
    f = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    ours = tmdf.local_average_similarity(torch.from_numpy(f), w).numpy()
    np.testing.assert_allclose(ours, _lcl_numpy(feats, w), atol=1e-5)
    np.testing.assert_allclose(
        ours, np.asarray(jmdf.local_average_similarity(jnp.asarray(f), w)),
        atol=1e-5)


def _both_select(feats, k, **kw):
    ours, ours_ex = tmdf.mdf_select(torch.from_numpy(feats), k, **kw)
    ref, ref_ex = jmdf.mdf_select(jnp.asarray(feats), k, **kw)
    assert ours.dtype == torch.int64
    return (ours.tolist(), bool(ours_ex)), (np.asarray(ref).tolist(),
                                           bool(ref_ex))


@pytest.mark.parametrize("seed", range(8))
def test_suppression_topk_equals_heap_and_jax(seed):
    feats = np.random.default_rng(seed).normal(size=(80, 12)).astype(
        np.float32)
    ours, ref = _both_select(feats, 8, window=5)
    assert ours == ref
    assert ours[0] == jmdf.mdf_reference_numpy(
        feats.astype(np.float64), 8, window=5).tolist()


@pytest.mark.parametrize("case", ["fallback", "adaptive", "ties"])
def test_select_cases_equal_jax(case):
    """The exhausted fallback (W so large the mask empties), the adaptive
    width N // 20, and tied scores (repeated frames: the stable fallback
    puts the lower index first, as JAX's top_k and the oracle do)."""
    rng = np.random.default_rng(3)
    if case == "fallback":
        feats, k, kw = rng.normal(size=(40, 8)), 8, {"window": 15}
    elif case == "adaptive":
        feats, k, kw = rng.normal(size=(100, 8)), 6, {"window": -1}
    else:
        feats = np.repeat(rng.normal(size=(6, 8)), 5, axis=0)
        k, kw = 8, {"window": 6}
    feats = feats.astype(np.float32)
    ours, ref = _both_select(feats, k, **kw)
    assert ours == ref
    assert ours[1] == (case != "adaptive")
    assert ours[0] == jmdf.mdf_reference_numpy(feats, k, **kw).tolist()


@pytest.mark.parametrize("n,w,bucket", [(20, 4, 64), (100, 5, 128),
                                        (64, 8, 64)])
def test_padded_equals_unpadded_and_jax(n, w, bucket):
    feats = np.random.default_rng(13).normal(size=(n, 8)).astype(np.float32)
    padded = np.zeros((bucket, 8), np.float32)
    padded[:n] = feats
    got, got_ex = tmdf.mdf_select_padded(torch.from_numpy(padded), n, 6, w)
    ref, ref_ex = jmdf.mdf_select_padded(jnp.asarray(padded), n, 6, w)
    unpadded, un_ex = tmdf.mdf_select(torch.from_numpy(feats), 6, window=w)
    assert got.tolist() == np.asarray(ref).tolist() == unpadded.tolist()
    assert bool(got_ex) == bool(ref_ex) == bool(un_ex)
    assert got.tolist() == tmdf.mdf_reference_numpy(feats, 6, w).tolist()


def test_batched_and_pipeline():
    feats = np.random.default_rng(5).normal(size=(3, 50, 8)).astype(
        np.float32)
    picks, flags = tmdf.mdf_select_batched(torch.from_numpy(feats), 4, 3)
    ref, ref_flags = jmdf.mdf_select_batched(jnp.asarray(feats), 4, 3)
    assert picks.tolist() == np.asarray(ref).tolist()
    assert flags.tolist() == np.asarray(ref_flags).tolist()
    pipe = tmdf.make_mdf_pipeline(lambda x: x.reshape(x.shape[0], -1), 4, 3)
    got, _ = pipe(torch.from_numpy(feats[0]))
    assert got.tolist() == picks[0].tolist()


# ---- frame helpers ---------------------------------------------------------


def test_frame_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for h, w in [(48, 64), (64, 48), (37, 53), (33, 97), (32, 32)]:
        frames = rng.integers(0, 256, size=(3, h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(text.geometry_frames(frames, 32),
                                      jext.geometry_frames(frames, 32))
        np.testing.assert_array_equal(text.preprocess_frames(frames, 32),
                                      jext.preprocess_frames(frames, 32))
        assert text._hf_resize_dims(h, w, 17) == jext._hf_resize_dims(h, w,
                                                                      17)
    for n, k in [(30, 4), (3, 4), (100, 16), (7, 7)]:
        np.testing.assert_array_equal(text._uniform_centers(n, k),
                                      jext._uniform_centers(n, k))
        np.testing.assert_array_equal(
            text.git6_indices(n, k, 4, np.random.default_rng((666, n))),
            jext.git6_indices(n, k, 4, np.random.default_rng((666, n))))
    assert [text.bucket_for(n) for n in (1, 64, 65, 2048, 5000)] == \
        [jext.bucket_for(n) for n in (1, 64, 65, 2048, 5000)]
    assert text.parse_shard(None) is None
    assert text.parse_shard("3/4") == jext.parse_shard("3/4") == (3, 4)
    assert text.parse_shard("auto") == (0, 1)
    with pytest.raises(ValueError):
        text.parse_shard("4/4")


# ---- extract_frames.main ---------------------------------------------------


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """tests/test_shard_tools.py's dataset with 3 scenes a video: 5
    non-square MJPG videos of 30 frames, qa_{train,val}.json."""
    root = tmp_path_factory.mktemp("stage_a")
    vdir = root / "msvd_qa" / "video"
    adir = root / "msvd_qa" / "annotations"
    vdir.mkdir(parents=True)
    adir.mkdir(parents=True)
    w, h = 48, 36
    names = [f"clip{v}.avi" for v in range(5)]
    for v, name in enumerate(names):
        writer = cv2.VideoWriter(str(vdir / name),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                                 (w, h))
        rng = np.random.default_rng(v)
        for _ in range(3):
            base = rng.integers(0, 255, size=3)
            for _ in range(10):
                writer.write((np.full((h, w, 3), base)
                              + rng.integers(0, 40, size=(h, w, 3))
                              ).clip(0, 255).astype(np.uint8))
        writer.release()
    for split in ("train", "val"):
        with open(adir / f"qa_{split}.json", "w") as f:
            json.dump([dict(question=f"what is in video {v} ({split})?",
                            answer="cat", video=name, answer_type="what")
                       for v, name in enumerate(names)], f)
    return str(root)


def _args(root, strategy, fname, *extra):
    return ["--dataset", "msvd_qa", "--dataset_root", root,
            "--sampling_strategy", strategy, "--K", "3", "--img_size", "32",
            "--h5_fname", fname, *extra]


def _store(root, fname, reader=FrameStoreReader):
    out = os.path.join(root, "msvd_qa", fname)
    r = reader(os.path.join(out, "msvd_qa_video_feat.h5"))
    data = np.stack([np.asarray(r._ds()[i]) for i in range(r.shape[0])])
    r.close()
    with open(os.path.join(out, "vidmapping.json"), "rb") as f:
        return data, f.read()


@pytest.mark.parametrize("strategy", ["uni", "git6"])
def test_extract_equals_jax_and_shards_merge(dataset_root, strategy):
    """One-shot stores and vidmapping.json equal the JAX tool's bit for
    bit; two shards merged equal the one-shot run (the merged mapping
    as a dict: the merge lists ids shard by shard, as JAX's does)."""
    jext.main(_args(dataset_root, strategy, f"jax_{strategy}"))
    text.main(_args(dataset_root, strategy, f"port_{strategy}",
                    "--platform", "cpu"))
    for i in (0, 1):
        text.main(_args(dataset_root, strategy, f"shard_{strategy}",
                        "--shard", f"{i}/2", "--platform", "cpu"))
    text.main(_args(dataset_root, strategy, f"shard_{strategy}",
                    "--merge_shards", "--platform", "cpu"))
    want, want_map = _store(dataset_root, f"jax_{strategy}", JReader)
    got, got_map = _store(dataset_root, f"port_{strategy}")
    assert got.shape == (5, 3, 3 * 32 * 32)
    np.testing.assert_array_equal(got, want)
    assert got_map == want_map
    merged, merged_map = _store(dataset_root, f"shard_{strategy}")
    np.testing.assert_array_equal(merged, want)
    assert json.loads(merged_map) == json.loads(want_map)


def test_merge_refuses_incomplete_shard_set(dataset_root):
    text.main(_args(dataset_root, "uni", "partial", "--shard", "0/3",
                    "--platform", "cpu"))
    with pytest.raises(FileNotFoundError, match="missing"):
        text.main(_args(dataset_root, "uni", "partial", "--merge_shards",
                        "--platform", "cpu"))


@pytest.fixture(scope="module")
def vision_weights(tmp_path_factory):
    """A seeded HF CLIPVisionModel checkpoint at GIT-base's vision widths
    and 32x32 images (the --vision_weights both tools load)."""
    import dataclasses

    from sasvqa_torch.models.git import GIT_BASE
    from sasvqa_torch.tools.hf_checkpoint import (hf_clip_vision_shapes,
                                                  write_hf_checkpoint)
    vc = dataclasses.replace(GIT_BASE.vision, image_size=32)
    root, _, _ = write_hf_checkpoint(
        str(tmp_path_factory.mktemp("vision")), hf_clip_vision_shapes(vc),
        seed=4)
    return root


@pytest.fixture(scope="module")
def repr_runs(dataset_root, vision_weights):
    """The port tool's repr run over the dataset, and both packages'
    encoders on the same --vision_weights."""
    import jax
    text.main(_args(dataset_root, "repr", "port_repr", "--vision_weights",
                    vision_weights, "--platform", "cpu"))
    jenc = jext.MDFEncoder(3, 8, weights_path=vision_weights, img_size=32)
    tenc = text.MDFEncoder(3, 8, weights_path=vision_weights, img_size=32,
                           device="cpu")
    japply = jax.jit(jenc._tower.apply)

    def jax_pooled(padded):
        return np.asarray(japply(jenc._params, jnp.asarray(padded))[1],
                          np.float32)

    return jenc, tenc, jax_pooled


def _video_frames(root, vid):
    path = os.path.join(root, "msvd_qa", "video", f"{vid}.avi")
    return text.normalize_frames(text.decode_frames(path, 32, 1))


def test_mdf_encoder_towers_agree(repr_runs, dataset_root):
    """The JAX tower's parameters carried into the port's layout equal
    the port loader's (bit for bit), and the two towers' pooled features
    agree within bf16 rounding."""
    from sasvqa_torch.models.convert import state_dict_from_flax
    jenc, tenc, jax_pooled = repr_runs
    carried = state_dict_from_flax(numpy_tree(jenc._params))
    loaded = tenc.tower.state_dict()
    assert carried.keys() == loaded.keys()
    for name, val in carried.items():
        assert torch.equal(val, loaded[name]), name
    padded, n, _ = tenc.pad(_video_frames(dataset_root, "clip0"))
    np.testing.assert_allclose(tenc.encode(padded).numpy()[:n],
                               jax_pooled(padded)[:n], atol=POOLED_ATOL)


class PickSwap(RuntimeWarning):
    """The two towers' bf16 features pick different MDF frames."""


def test_repr_picks_on_each_side(repr_runs, dataset_root):
    """The selection is exact on shared (the JAX tower's) features, and
    the port's store holds its picks.  Where the two towers' bf16
    features swap a pick, the test says so (a PickSwap warning) and holds
    each package to its own oracle; otherwise the store equals what the
    JAX tool's selection stores."""
    jenc, tenc, jax_pooled = repr_runs
    data, vidmap = _store(dataset_root, "port_repr")
    swaps = []
    for vid, row in json.loads(vidmap).items():
        frames = _video_frames(dataset_root, vid)
        padded, n, w = tenc.pad(frames)
        jfeats = jax_pooled(padded)
        jpicks, jex = jmdf.mdf_select_padded(jnp.asarray(jfeats), n, 3, w)
        jpicks = np.asarray(jpicks)
        ours, ours_ex = tmdf.mdf_select_padded(torch.from_numpy(jfeats), n,
                                               3, w)
        assert ours.tolist() == jpicks.tolist(), vid
        assert bool(ours_ex) == bool(jex)
        tpicks, _ = tenc(frames)
        for feats, picks in ((jfeats, jpicks),
                             (tenc.encode(padded).numpy(), tpicks)):
            assert picks.tolist() == jmdf.mdf_reference_numpy(
                feats[:n], 3, w).tolist(), vid
        stored = frames[tpicks]
        if tpicks.tolist() != jpicks.tolist():
            swaps.append((vid, tpicks.tolist(), jpicks.tolist()))
        else:
            stored = frames[jpicks]
        np.testing.assert_array_equal(
            data[row], stored.transpose(0, 3, 1, 2).reshape(3, -1))
    if swaps:
        warnings.warn(f"bf16 tower features swap MDF picks: {swaps}",
                      PickSwap)
