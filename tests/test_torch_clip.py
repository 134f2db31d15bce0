"""The port's CLIP classifier slice vs the JAX package, in f32 on the CPU at
tiny-clip width: the text encoder (causal + padding bias, EOS pooling,
projection), CLIPVideoQA's logits, loss and gradients with two questions
a video, the BPE tokenizer (also against transformers), multi-clip score
pooling, and QAEngine answers from weights loaded out of a saved HF
checkpoint by each package's loader."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.data import tokenization as jtok
from sasvqa_tpu.models import clip as jclip
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.tasks import serve as jserve
from sasvqa_tpu.train import retrieval as jretrieval

from sasvqa_torch.data import tokenization as ttok
from sasvqa_torch.models import clip as tclip
from sasvqa_torch.models import presets as tpresets
from sasvqa_torch.models.convert import state_dict_from_flax
from sasvqa_torch.ops import _build
from sasvqa_torch.tasks import serve as tserve
from sasvqa_torch.train.retrieval import aggregate_clip_scores

from _torch_parity import (frames, hf_tiny_clip, load_flax_params,
                           numpy_tree, save_hf, to_torch)

ANS = {"dog": 0, "cat": 1, "red": 2, "ball": 3, "man": 4}
TINY_CLIP = {"model": {"pretrained_model": "tiny-clip",
                       "hidden_dropout_prob": 0.0},
             "img_size": 32, "num_labels": len(ANS), "classifier": "mlp"}
EOS = tpresets.TINY_TEXT.eos_token_id


def _close(ours, ref, err_msg="", atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(
        ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours,
        np.asarray(ref), atol=atol, rtol=rtol, err_msg=err_msg)


def _text_batch():
    """Row 0 ends on EOS, row 1 has EOS mid-row then padding, row 2 has
    no EOS (pools its last position), row 3 two EOS (the first counts)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(3, EOS - 1, size=(4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[0, -1] = EOS
    ids[1, 6] = EOS
    mask[1, 7:] = 0
    ids[3, [4, 9]] = EOS
    return ids, mask


@pytest.mark.parametrize("with_projection", [False, True])
def test_text_encoder_matches_jax(with_projection):
    cfg = tpresets.TINY_TEXT
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(
        **dataclasses.asdict(cfg)), with_projection=with_projection,
        projection_dim=24)
    tm = tclip.CLIPTextEncoder(cfg, with_projection=with_projection,
                               projection_dim=24)
    ids, mask = _text_batch()
    params = jax.jit(jm.init)(jax.random.key(0), ids, mask)
    load_flax_params(tm, params)
    for m in (mask, None):
        jh, jp = jax.jit(jm.apply)(params, ids, m)
        with torch.no_grad():
            th, tp = tm(to_torch(ids, torch.long),
                        None if m is None else to_torch(m))
        _close(th, jh, "hidden")
        _close(tp, jp, "pooled", atol=1e-4, rtol=1e-4)
    assert tp.shape == (4, 24 if with_projection else cfg.hidden_size)
    long_ids = np.ones((1, cfg.max_position_embeddings + 1), np.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm(to_torch(long_ids, torch.long))


@pytest.fixture(scope="module")
def tiny_clip():
    """The JAX tiny CLIPVideoQA, its params, and the port's model carried
    over from them."""
    family, jm = jpresets.build_model(ConfigDict(TINY_CLIP),
                                      dtype=jnp.float32)
    ids = jnp.ones((2, 5), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), ids, ids,
                              jnp.zeros((2, 2, 32, 32, 3)))
    fam, tm = tpresets.build_model(TINY_CLIP, device="cpu")
    assert family == fam == "clip"
    load_flax_params(tm, params)
    return jm, params, tm


def test_video_qa_logits_loss_and_grads_match_jax(tiny_clip):
    """4 questions over 2 videos (the frame embeddings repeat after the
    encoder), one label ignored: logits and loss within 1e-5, every
    gradient within 1e-4 of its norm."""
    jm, params, tm = tiny_clip
    rng = np.random.default_rng(1)
    ids = rng.integers(3, EOS, size=(4, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1:, 5:] = 0
    labels = np.array([0, 3, -100, 4], np.int32)
    px = rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)

    def loss_fn(p):
        out = jm.apply(p, ids, mask, px, labels=labels)
        return out["loss"], out["logits"]

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tm.zero_grad()
    out = tm(to_torch(ids, torch.long), to_torch(mask), to_torch(px),
             labels=to_torch(labels, torch.long))
    out["loss"].backward()
    _close(out["logits"], jlogits, "logits")
    _close(out["loss"], jloss, "loss")
    ref = state_dict_from_flax(numpy_tree(jgrads))
    for name, p in tm.named_parameters():
        grad = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        want = ref[name].numpy()
        # a key bias has a true gradient of 0 (softmax ignores a constant
        # added to every key): both sides hold f32 rounding noise there,
        # held absolutely
        if name.endswith("k_proj.bias"):
            np.testing.assert_allclose(grad, want, atol=1e-6, err_msg=name)
            continue
        if name.endswith("qkv.bias"):
            d = want.shape[0] // 3
            np.testing.assert_allclose(grad[d:2 * d], want[d:2 * d],
                                       atol=1e-6, err_msg=name)
            grad = np.delete(grad, np.s_[d:2 * d])
            want = np.delete(want, np.s_[d:2 * d])
        err = float(np.abs(grad - want).max()) / max(
            float(np.linalg.norm(want)), 1e-30)
        assert err <= 1e-4, (name, err)
    assert tm.vis_model.layers_0.self_attn.qkv.weight.grad.abs().sum() > 0
    assert tm.txt_model.layers_0.mlp.fc1.weight.grad.abs().sum() > 0


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """A tiny BPE vocabulary (the one tests/test_tokenizers.py uses)."""
    import json
    chars = list("abcdefghijklmnopqrstuvwxyz?!.,&0123456789")
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = ["t h", "th e</w>", "i s</w>", "w h", "wh a", "wha t</w>",
              "d o", "do g</w>", "a n", "an d</w>", "m a", "ma n</w>",
              "i n", "in g</w>", "n n", "r u", "ru nn", "runn ing</w>"]
    for m in merges:
        tok = m.replace(" ", "")
        if tok not in vocab:
            vocab[tok] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    d = tmp_path_factory.mktemp("cliptok")
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                  + "\n")
    return str(d)


SENTENCES = ["the man is running", "what dog", "a and the", "man?!",
             "  What IS the dog   doing, man?", "running 42 dogs"]


def test_bpe_tokenizer_matches_jax_and_hf(clip_files):
    import os
    from transformers import CLIPTokenizer
    vpath = os.path.join(clip_files, "vocab.json")
    mpath = os.path.join(clip_files, "merges.txt")
    ours = ttok.CLIPBPETokenizer.from_files(vpath, mpath)
    ref = jtok.CLIPBPETokenizer.from_files(vpath, mpath)
    hf = CLIPTokenizer(vpath, mpath)
    for s in SENTENCES:
        got = [ours.bos_token_id] + ours.tokenize_ids(s) + \
            [ours.eos_token_id]
        assert got == hf.encode(s), s
        assert ours.decode(got) == ref.decode(got)
    for key, val in ref(SENTENCES, max_length=6).items():
        np.testing.assert_array_equal(ours(SENTENCES, max_length=6)[key],
                                      val, err_msg=key)
    # the loop's tokenizer for CLIP: vocab.json + merges.txt under
    # tokenizer_dir
    from sasvqa_torch.tasks.run_video_qa import build_tokenizer
    tok = build_tokenizer({"tokenizer_dir": clip_files}, "clip")
    assert isinstance(tok, ttok.CLIPBPETokenizer)
    with pytest.raises(FileNotFoundError, match="no vocab files"):
        build_tokenizer({"tokenizer_dir": clip_files}, "git")


@pytest.mark.parametrize("agg", ["mean", "max", "lse"])
def test_aggregate_clip_scores_matches_jax(agg):
    scores = np.random.default_rng(2).normal(size=(3, 7, 4)) \
        .astype(np.float32) * 5
    ref = jretrieval.aggregate_clip_scores(jnp.asarray(scores), agg)
    _close(aggregate_clip_scores(torch.from_numpy(scores), agg), ref,
           atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="score_agg_func"):
        aggregate_clip_scores(torch.from_numpy(scores), "median")


ENGINE_KW = dict(nframe=2, samp_policy="uniform", batch_size=4,
                 linger_ms=30.0, max_txt_len=8)


def test_qa_engine_answers_match_jax_engine(tiny_clip, clip_files,
                                            tmp_path):
    """Both packages load the same saved HF CLIPModel onto the same init
    with their loaders, then QAEngine(family="clip") answers 6 requests
    (two batches, the second padded) as the JAX engine does; the model
    never reaches a kernel on the CPU."""
    import os
    jm, params, _ = tiny_clip
    path = save_hf(hf_tiny_clip(seed=5), tmp_path / "clip", "bin")
    jparams = jpresets.load_pretrained_params("clip", jm, params, path)
    _, tm = tpresets.build_model(TINY_CLIP, device="cpu")
    load_flax_params(tm, params)
    report = tpresets.load_pretrained_params("clip", tm, path)
    assert report["missing_in_ckpt"] == ["/answer_head"]
    files = (os.path.join(clip_files, "vocab.json"),
             os.path.join(clip_files, "merges.txt"))
    questions = ["what is the dog doing", "the man is running",
                 "what color is the ball", "where is the cat running",
                 "and", "what is the man doing"]
    reqs = [(frames(40 + i, 6, 32), questions[i]) for i in range(6)]
    with jserve.QAEngine(jm, jparams, "clip",
                         jtok.CLIPBPETokenizer.from_files(*files),
                         ans2label=ANS, **ENGINE_KW) as jeng:
        ref = [jeng.answer(f, q, timeout=300) for f, q in reqs]
    _build.reset_launch_counts()
    with tserve.QAEngine(tm, "clip", ttok.CLIPBPETokenizer.from_files(*files),
                         ans2label=ANS, device="cpu", **ENGINE_KW) as eng:
        futs = [eng.submit(f, q) for f, q in reqs]
        ours = [f.result(timeout=300) for f in futs]
    assert ours == ref
    assert all(o["answer"] in ANS for o in ours)
    assert not any(_build.launch_counts.values())
