"""The retrieval task of the port vs the JAX package on the CPU: the
Recall@K / MedR / MeanR metrics (ties included) and the cosine similarity,
the projected CLIP towers carried from Flax params, and
``run_retrieval.main`` end to end on the same synthetic store and the
same tiny HF CLIPModel checkpoint (test_aux.py's task), both packages'
towers in f32: per-frame embeddings within 1e-5 and equal metric
dicts."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.data.synthetic import make_synthetic_dataset
from sasvqa_tpu.tasks import run_retrieval as jret
from sasvqa_tpu.train import retrieval as jretrieval

from sasvqa_torch.tasks import run_retrieval as tret
from sasvqa_torch.train import retrieval as tretrieval

from _torch_parity import hf_tiny_clip, load_flax_params, save_hf

TOL_EMBED = 1e-5


@pytest.mark.parametrize("kind", ["random", "ties", "shifted"])
def test_retrieval_metrics_equal_jax(kind):
    rng = np.random.default_rng(3)
    n = 23
    if kind == "random":
        s = rng.normal(size=(n, n)) + np.eye(n)
    elif kind == "ties":
        # scores from {0, 1, 2}: most rows tie the true video with others
        s = rng.integers(0, 3, size=(n, n)).astype(np.float32)
    else:
        s = np.zeros((n, n))
        for i in range(n):
            s[i, i], s[i, (i + 1) % n] = 5.0, 10.0
    got = tretrieval.retrieval_metrics(s)
    assert got == jretrieval.retrieval_metrics(s)
    assert set(got) == {"r1", "r5", "r10", "medianR", "meanR"}


def test_similarity_matrix_matches_jax():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(6, 16)).astype(np.float32)
    v = rng.normal(size=(9, 16)).astype(np.float32)
    for normalize in (True, False):
        want = np.asarray(jretrieval.similarity_matrix(
            jnp.asarray(t), jnp.asarray(v), normalize))
        got = tretrieval.similarity_matrix(torch.from_numpy(t),
                                           torch.from_numpy(v), normalize)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_projected_towers_carry_flax_params():
    """build_towers' projected towers loaded with the JAX towers' Flax
    params (text_projection and visual_projection included) give the
    JAX towers' projected embeddings (f32)."""
    cfg = {"model": {"pretrained_model": "tiny-clip", "vocab_size": 512},
           "img_size": 32}
    jt, jv = jret.build_towers(ConfigDict(cfg), dtype=jnp.float32)
    tt, tv = tret.build_towers(cfg, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(5, 500, size=(3, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 4:] = 0
    px = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    tp = jax.jit(jt.init)(jax.random.key(0), ids, mask)
    vp = jax.jit(jv.init)(jax.random.key(1), px)
    assert "text_projection" in tp["params"]
    assert "visual_projection" in vp["params"]
    load_flax_params(tt, tp)
    load_flax_params(tv, vp)
    _, jtxt = jt.apply(tp, ids, mask)
    _, _, jimg = jv.apply(vp, px)
    with torch.no_grad():
        _, ttxt = tt(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        _, _, timg = tv(torch.from_numpy(px))
    np.testing.assert_allclose(ttxt.numpy(), np.asarray(jtxt),
                               atol=TOL_EMBED, rtol=0)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg),
                               atol=TOL_EMBED, rtol=0)


def _f32_towers(monkeypatch, module, dtype):
    real = module.build_towers
    monkeypatch.setattr(module, "build_towers",
                        lambda cfg, **kw: real(cfg, **dict(kw, dtype=dtype)))


def _capture(monkeypatch, module, seen):
    real = module.encode_corpus

    def encode(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(module, "encode_corpus", encode)


@pytest.fixture(scope="module")
def both_mains(tmp_path_factory):
    """One run of each package's main on the same store and checkpoint:
    12 videos, 3 frames each, chunks of 5 (the last one partial), LSE
    pooling; both towers in f32."""
    root = tmp_path_factory.mktemp("retrieval")
    paths = make_synthetic_dataset(str(root / "d"), num_videos=12,
                                   stored_frames=8, img_hw=32,
                                   questions_per_video=1)
    weights = save_hf(hf_tiny_clip(seed=3), root / "ckpt", "safetensors")
    cfg = {"task": "msvd_qa",
           "val_datasets": [{"name": "msvd_qa", "txt": paths["val"],
                             "img": paths["h5"]}],
           "vid_mapping": paths["vidmapping"],
           "model": {"pretrained_model": "tiny-clip", "vocab_size": 512,
                     "pretrained_weights": weights},
           "img_size": 32, "nframe": 3, "max_txt_len": 12,
           "val_batch_size": 5, "score_agg_func": "lse",
           "platform": "cpu"}
    p = root / "cfg.json"
    p.write_text(json.dumps(cfg))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, module, dtype in (("jax", jret, jnp.float32),
                                    ("port", tret, torch.float32)):
            seen = []
            _f32_towers(mp, module, dtype)
            _capture(mp, module, seen)
            metrics = module.main(["--config", str(p)])
            out[name] = (metrics, seen[0])
    return out


def test_main_embeddings_match_jax(both_mains):
    (_, jemb), (_, temb) = both_mains["jax"], both_mains["port"]
    assert temb["text"].shape == (12, 32)
    assert temb["video"].shape == (12, 3, 32)
    for key in ("text", "video"):
        np.testing.assert_allclose(temb[key],
                                   np.asarray(jemb[key], np.float32),
                                   atol=TOL_EMBED, rtol=0, err_msg=key)


def test_main_metrics_equal_jax(both_mains):
    (jm, _), (tm, _) = both_mains["jax"], both_mains["port"]
    assert tm == jm
    assert set(tm) == {"r1", "r5", "r10", "medianR", "meanR"}


@pytest.mark.parametrize("agg", ["mean", "max", "lse"])
def test_clip_score_matrix_matches_jax(both_mains, agg):
    """The per-frame cosine scores pooled over frames, as the JAX
    evaluate_retrieval pools them, on the port's embeddings."""
    emb = both_mains["port"][1]
    txt = jnp.asarray(emb["text"])
    vid = jnp.asarray(emb["video"])
    txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
    vid = vid / jnp.linalg.norm(vid, axis=-1, keepdims=True)
    want = np.asarray(jretrieval.aggregate_clip_scores(
        jnp.einsum("td,vfd->tvf", txt, vid), agg, axis=-1))
    got = tret.clip_score_matrix(emb["text"], emb["video"], agg, "cpu")
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_main_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"task": "msvd_qa",
                             "model": {"pretrained_model": "tiny-clip"}}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tret.main(["--config", str(p)])
