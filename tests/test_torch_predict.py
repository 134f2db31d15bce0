"""The port's single-video predict CLI and JSONL serve CLI against the JAX
package's, on the same videos, flags and HF checkpoint (tiny models).

Both CLIs build their models in bf16.  The random tiny weights give
logits that tie within bf16 rounding, which the two frameworks do in
different orders, so a greedy decode of ~40 tokens can take another token
(seen: one of ~40 in a serve answer).  The comparisons therefore build
both packages' models in f32 (the ``f32_models`` fixture wraps the
``build_model`` each CLI calls); the port's bf16 predict is checked to
answer.

Tolerances: decoded frames equal; generated token ids, answers and the
serve CLI's JSONL lines equal (f32); classifier answers equal (f32).
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax
import jax.numpy as jnp

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.models.git import greedy_generate as jax_generate
from sasvqa_tpu.models.presets import load_pretrained_params
from sasvqa_tpu.tasks import predict as jpredict
from sasvqa_tpu.tasks import serve as jserve

from sasvqa_torch.core.checkpoint import ModelSaver
from sasvqa_torch.data.tokenization import make_test_wordpiece
from sasvqa_torch.tasks import predict as tpredict
from sasvqa_torch.tasks import serve as tserve

from _torch_parity import hf_tiny_git, load_flax_params, save_hf

QUESTION = "what is the dog doing?"
IMG, NFRAME, MAX_LEN = 32, 2, 12


def _write_video(path, seed, n=20, size=(48, 40)):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, size)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w.write(rng.integers(0, 255, size=(size[1], size[0], 3)).astype(
            np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    videos = [_write_video(str(root / f"clip{i}.avi"), i) for i in range(3)]
    weights = save_hf(hf_tiny_git(num_frames=NFRAME, seed=3),
                      root / "git", "bin")
    return str(root), videos, weights


@pytest.fixture
def f32_models(monkeypatch):
    """The ``build_model`` of each package's CLIs builds in f32 whatever
    the caller asks (the CLIs ask for bf16)."""
    for mod, f32 in ((jpresets, jnp.float32), (tpredict, torch.float32)):
        build = mod.build_model
        monkeypatch.setattr(mod, "build_model", lambda cfg, dtype=None,
                            _b=build, _f=f32, **kw: _b(cfg, dtype=_f, **kw))


def _flags(video, weights, **kw):
    flags = {"video": video, "question": QUESTION, "model": "tiny-git",
             "weights": weights, "nframe": NFRAME, "img_size": IMG,
             "max_length": MAX_LEN, **kw}
    return [x for k, v in flags.items() if v is not None
            for x in (f"--{k}", str(v))]


def test_predict_bf16_answers(files):
    """The CLI as shipped (a bf16 model) answers with a string."""
    _, videos, weights = files
    got = tpredict.main(_flags(videos[0], weights, platform="cpu"))
    assert isinstance(got, str)


def test_predict_git_equals_jax(files, f32_models):
    """The same frames, prompt, generated ids and answer as the JAX
    package's predict on one HF checkpoint."""
    _, videos, weights = files
    frames = tpredict.load_frames(videos[0], NFRAME, IMG)
    np.testing.assert_array_equal(
        frames, jpredict.load_frames(videos[0], NFRAME, IMG))

    args = jpredict.build_argparser().parse_args(_flags(videos[0], weights))
    want = jpredict.predict(args)
    got = tpredict.main(_flags(videos[0], weights, platform="cpu"))
    assert got == want

    # the generated ids, from the JAX package's model on those weights
    cfg = ConfigDict({"model": {"pretrained_model": "tiny-git",
                                "vocab_size": None}, "img_size": IMG})
    family, jm = jpresets.build_model(cfg)
    tok = make_test_wordpiece()
    # predict's prompt: [CLS] + the question, cut to max_length - 8
    ids = ([tok.cls_token_id]
           + tok.encode(QUESTION, add_special_tokens=False))[:MAX_LEN - 8]
    jids = jnp.asarray([ids], jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), jids, jnp.ones_like(jids),
                              jnp.asarray(frames)[:, :1])
    params = load_pretrained_params(family, jm, params, weights)
    want_ids = np.asarray(jax_generate(jm, params, jids,
                                       jnp.asarray([len(ids)], jnp.int32),
                                       jnp.asarray(frames),
                                       max_text_len=MAX_LEN))[0]
    targs = tpredict.build_argparser().parse_args(
        _flags(videos[0], weights, platform="cpu"))
    fam, model, ttok = tpredict.load_model(targs, None, "cpu")
    assert model.dtype == torch.float32          # f32_models took effect
    out = tpredict.answer_from_frames(model, fam, ttok, frames, QUESTION,
                                      max_length=MAX_LEN, device="cpu")
    assert out["ids"].tolist() == want_ids.tolist()
    assert out["answer"] == want


def test_predict_classifier_from_port_snapshot(files, tmp_path,
                                               f32_models):
    """A classifier answers from a ModelSaver snapshot of this package
    (the JAX package's tiny-clip parameters, perturbed, carried across):
    the same answer as the JAX CLI on its own snapshot of those
    parameters; the other head shape does not load."""
    from sasvqa_tpu.core.checkpoint import ModelSaver as JSaver

    _, videos, _ = files
    cfg = ConfigDict({"model": {"pretrained_model": "tiny-clip",
                                "vocab_size": None}, "img_size": IMG,
                      "num_labels": 5, "tokenizer_dir": None,
                      "classifier": "mlp"})
    _, jm = jpresets.build_model(cfg)
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), ids, jnp.ones_like(ids),
                              jnp.zeros((1, 2, IMG, IMG, 3)))
    params = jax.tree_util.tree_map(lambda x: x + 0.1, params)
    jsaver = JSaver(str(tmp_path / "jax_ckpt"))
    jsaver.save(3, jax.device_get(params))
    jsaver.wait()
    targs = tpredict.build_argparser().parse_args(
        _flags(videos[0], None, model="tiny-clip", num_labels=5))
    _, tm, _ = tpredict.load_model(targs, None, "cpu")
    load_flax_params(tm, params)
    ModelSaver(str(tmp_path / "ckpt")).save(3, tm.state_dict())

    a2l = str(tmp_path / "ans2label.json")
    with open(a2l, "w") as f:
        json.dump({"yes": 0, "no": 1, "cat": 2, "dog": 3, "red": 4}, f)
    common = dict(model="tiny-clip", num_labels=5, ans2label=a2l)
    want = jpredict.predict(jpredict.build_argparser().parse_args(
        _flags(videos[1], None, orbax_ckpt=str(tmp_path / "jax_ckpt"),
               **common)))
    got = tpredict.main(_flags(videos[1], None, platform="cpu",
                               orbax_ckpt=str(tmp_path / "ckpt"), **common))
    assert got == want and got in ("yes", "no", "cat", "dog", "red")
    with pytest.raises(RuntimeError, match="state_dict"):
        tpredict.main(_flags(videos[1], None, platform="cpu",
                             orbax_ckpt=str(tmp_path / "ckpt"),
                             classifier="linear", **common))


def test_serve_cli_equals_jax(files, f32_models):
    """The serve CLI's JSONL answers equal the JAX CLI's on 3 videos."""
    root, videos, weights = files
    requests = os.path.join(root, "requests.jsonl")
    with open(requests, "w") as f:
        for i, v in enumerate(videos):
            f.write(json.dumps({"video": v, "question":
                                ["what is the dog doing", "who is in the "
                                 "video", "what color is the ball"][i]})
                    + "\n")
    common = ["--requests", requests, "--model", "tiny-git", "--weights",
              weights, "--nframe", str(NFRAME), "--img_size", str(IMG),
              "--stored_frames", "6", "--batch_size", "4",
              "--decode_workers", "2"]
    outs = {}
    for name, main, extra in (("jax", jserve.main, []),
                              ("port", tserve.main, ["--platform", "cpu"])):
        outs[name] = os.path.join(root, f"answers_{name}.jsonl")
        assert main(common + ["--out", outs[name]] + extra) == 0
    with open(outs["jax"]) as f, open(outs["port"]) as g:
        want, got = f.read().splitlines(), g.read().splitlines()
    assert len(got) == 3 and got == want
    assert [json.loads(line)["question"] for line in got][0] == \
        "what is the dog doing"


def test_clis_default_to_the_gpu(monkeypatch, files):
    """Without a GPU each CLI raises unless --platform cpu is passed."""
    from sasvqa_torch.tools import extract_frames, gen_sample
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, videos, weights = files
    for main, argv in (
            (tpredict.main, _flags(videos[0], weights)),
            (tserve.main, ["--requests", "r.jsonl", "--out", "o.jsonl"]),
            (extract_frames.main, ["--dataset_root", root]),
            (gen_sample.main, ["--dataset_root", root, "--task", "merge"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
