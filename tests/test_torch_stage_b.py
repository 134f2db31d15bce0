"""Stage B of the port (models/bert, sampling/mif, tools/gen_sample)
against the JAX package and a tiny HF BERT, on the same store,
annotations and HF checkpoints.

The captioner compares in f32: both tools build GIT in bf16, and a tiny
random GIT's logits tie within bf16 rounding, which the two frameworks
do in different orders (see tests/test_torch_predict.py).  The
``stage_b`` fixture wraps the ``GITForCausalLM`` each tool builds in f32
for the comparison; the port's bf16 captioner is checked to run.

The captioner's weights are HF's init scaled by 10 (matrices only): at
HF's init the tiny captioner gives one caption for every frame, and the
scorer's exact ties among identical captions then resolve by each
backend's last-ulp arithmetic (torch's CPU kernels score identical rows of
one batch 1 ulp apart, XLA's equal), which tests no port code.  The
fixture asserts that its captions are distinct.

Tolerances: BERT logits within 1e-5 (f32) of JAX and of HF;
``frame_captions.json`` and ``qa_winds_*.json`` equal the JAX tool's,
one-shot and two shards merged.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sasvqa_tpu.models import bert as jbert
from sasvqa_tpu.models import git as jgit
from sasvqa_tpu.sampling import mif as jmif
from sasvqa_tpu.tools import gen_sample as jgen

from sasvqa_torch.models import bert as tbert
from sasvqa_torch.models.convert import merge_pretrained
from sasvqa_torch.sampling import mif as tmif
from sasvqa_torch.tools import extract_frames as text
from sasvqa_torch.tools import gen_sample as tgen

from _torch_parity import hf_tiny_git, load_flax_params, save_hf

VOCAB = 512
TINY_BERT = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=4, intermediate_size=64,
                 max_position_embeddings=128)


def _bert_inputs(seed, b=5, l=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, size=(b, l)).astype(np.int32)
    lens = rng.integers(3, l + 1, size=b)
    mask = (np.arange(l)[None] < lens[:, None]).astype(np.int32)
    types = ((np.arange(l)[None] >= lens[:, None] // 2) & (mask == 1)
             ).astype(np.int32)
    return ids, mask, types


def _port_logits(model, ids, mask, types):
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask),
                     torch.from_numpy(types)).numpy()


def test_bert_logits_equal_jax():
    cfg = jbert.BERTConfig(**TINY_BERT)
    jm = jbert.BERTForSequenceClassification(cfg)
    ids, mask, types = _bert_inputs(0)
    params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(ids),
                              jnp.asarray(mask), jnp.asarray(types))
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(types)))
    tm = load_flax_params(
        tbert.BERTForSequenceClassification(tbert.BERTConfig(**TINY_BERT)),
        params).eval()
    got = _port_logits(tm, ids, mask, types)
    assert got.shape == (5, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def hf_tiny_bert(seed=0):
    """transformers.BertForSequenceClassification at TINY_BERT's widths."""
    from transformers import BertConfig, BertForSequenceClassification
    torch.manual_seed(seed)
    return BertForSequenceClassification(BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=128, num_labels=2)).eval()


def test_bert_logits_equal_hf():
    hf = hf_tiny_bert()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    tm = tbert.BERTForSequenceClassification(tbert.BERTConfig(**TINY_BERT))
    report = merge_pretrained(tm, tbert.convert_bert_classifier(sd, 2))
    assert not report["missing_in_ckpt"] and not report["mismatched"]
    ids, mask, types = _bert_inputs(1)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long(),
                  token_type_ids=torch.from_numpy(types).long()).logits
    np.testing.assert_allclose(_port_logits(tm.eval(), ids, mask, types),
                               want.numpy(), atol=1e-5)
    # and the JAX package's converter gives the same tree
    conv = tbert.convert_bert_classifier(sd, 2)
    jconv = jbert.convert_bert_classifier(sd, 2)
    flat = jax.tree_util.tree_leaves_with_path
    assert [(p, np.asarray(a).tolist()) for p, a in flat(conv)] == \
        [(p, np.asarray(a).tolist()) for p, a in flat(jconv)]


@pytest.mark.parametrize("scores,k,ds", [
    ([0.1, 0.9, 0.3, 0.8, 0.05, 0.7], 3, 1),
    ([0.1, 0.9, 0.3, 0.8, 0.05, 0.7], 2, 2),
    ([0.5, 0.5, 0.2, 0.5, 0.2], 4, 1),
    ([0.3, 0.1], 5, 1)])
def test_topk_downsampled_equals_jax(scores, k, ds):
    scores = np.asarray(scores, np.float32)
    assert tmif.topk_downsampled(scores, k, ds) == \
        jmif.topk_downsampled(scores, k, ds)


def test_caption_frames_equals_jax():
    """The stage-1 loop over (row, frames) stacks, with a deterministic
    generator of ids from the frames' means."""
    stacks = [(r, np.random.default_rng(r).normal(size=(3, 4, 4, 3)).astype(
        np.float32)) for r in range(3)]

    def ids_of(frames):
        m = np.asarray(frames).reshape(len(frames), -1).mean(-1)
        return (np.abs(m[:, None]) * 1e4 + np.arange(5)).astype(
            np.int64) % 100

    tok = tgen.make_test_wordpiece()
    got = tmif.caption_frames(lambda f: torch.from_numpy(ids_of(f)),
                              stacks, tok.decode)
    want = jmif.caption_frames(lambda f: ids_of(f), stacks, tok.decode)
    assert got == want and list(got) == [0, 1, 2]
    assert all(len(c) == 3 for c in got.values())


# ---- the tool ---------------------------------------------------------------


def _vocab_dir(root):
    """A WordPiece vocab covering the tiny models' 512 ids, so decoded
    captions are distinct strings."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is",
             "in", "video", "train", "val", "?", "(", ")"]
    words += [str(i) for i in range(5)]
    words += [f"w{i}" for i in range(VOCAB - len(words))]
    path = os.path.join(root, "vocab")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    return path


@pytest.fixture(scope="module")
def stage_b(tmp_path_factory):
    """A uni store of 5 videos (K=4) from the port's extractor, the
    annotations, a tiny HF GIT captioner and a tiny HF BERT scorer; each
    tool's one-shot gen_cap and gen_inds (captioners in f32), and the
    port's two-shard runs merged."""
    cv2 = pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("stage_b"))
    vdir = os.path.join(root, "msvd_qa", "video")
    adir = os.path.join(root, "msvd_qa", "annotations")
    os.makedirs(vdir)
    os.makedirs(adir)
    names = [f"clip{v}.avi" for v in range(5)]
    for v, name in enumerate(names):
        w = cv2.VideoWriter(os.path.join(vdir, name),
                            cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (48, 36))
        rng = np.random.default_rng(v)
        for _ in range(12):
            w.write(rng.integers(0, 256, (36, 48, 3), dtype=np.uint8))
        w.release()
    for split in ("train", "val"):
        with open(os.path.join(adir, f"qa_{split}.json"), "w") as f:
            json.dump([dict(question=f"what is in video {v} ({split})?",
                            answer="cat", video=name, answer_type="what")
                       for v, name in enumerate(names)], f)
    text.main(["--dataset_root", root, "--sampling_strategy", "uni",
               "--K", "4", "--img_size", "32", "--h5_fname", "proc",
               "--platform", "cpu"])
    captioner = hf_tiny_git(num_frames=1, seed=5)
    with torch.no_grad():
        for p in captioner.parameters():
            if p.ndim >= 2:
                p.mul_(10.0)
    git_w = save_hf(captioner, os.path.join(root, "git"), "bin")
    bert_w = save_hf(hf_tiny_bert(seed=6), os.path.join(root, "bert"), "bin")
    base = ["--dataset_root", root, "--h5_path", "proc", "--tokenizer_dir",
            _vocab_dir(root)]
    cap = base + ["--task", "gen_cap", "--vlm_model", "tiny-git",
                  "--weights", git_w, "--max_length", "6", "--batch_rows",
                  "2"]
    inds = base + ["--task", "gen_inds", "--K", "2", "--tiny", "--weights",
                   bert_w]
    port = ["--platform", "cpu"]

    def read():
        return {name: json.load(open(os.path.join(adir, name)))
                for name in ("frame_captions.json", "qa_winds_train.json",
                             "qa_winds_val.json")
                if os.path.exists(os.path.join(adir, name))}

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, f32 in ((jgit, jnp.float32), (tgen, torch.float32)):
            cls = mod.GITForCausalLM
            mp.setattr(mod, "GITForCausalLM", lambda cfg, dtype=None,
                       _c=cls, _f=f32, **kw: _c(cfg, dtype=_f, **kw))
        jgen.main(cap)
        jgen.main(inds)
        out["jax"] = read()
        tgen.main(cap + port)
        tgen.main(inds + port)
        out["port"] = read()
        for i in (0, 1):
            tgen.main(cap + port + ["--shard", f"{i}/2"])
        os.remove(os.path.join(adir, "frame_captions.json"))
        tgen.main(base + ["--task", "merge"] + port)
        for i in (0, 1):
            tgen.main(inds + port + ["--shard", f"{i}/2"])
        for split in ("train", "val"):
            os.remove(os.path.join(adir, f"qa_winds_{split}.json"))
        tgen.main(base + ["--task", "merge"] + port)
        out["merged"] = read()
    out["root"], out["base"], out["cap"], out["inds"] = root, base, cap, inds
    return out


def test_captions_equal_jax(stage_b):
    want = stage_b["jax"]["frame_captions.json"]
    got = stage_b["port"]["frame_captions.json"]
    assert list(got) == [str(r) for r in range(5)]
    assert all(len(c) == 4 for c in got.values())
    assert len({c for caps in got.values() for c in caps}) == 20
    assert got == want


def test_winds_equal_jax(stage_b):
    for split in ("train", "val"):
        name = f"qa_winds_{split}.json"
        got, want = stage_b["port"][name], stage_b["jax"][name]
        assert got == want and len(got) == 5
        assert all(len(s["sampled_inds"]) == 2
                   and all(0 <= i < 4 for i in s["sampled_inds"])
                   for s in got)


def test_shards_merge_equal_one_shot(stage_b):
    assert stage_b["merged"] == stage_b["port"]


def test_gen_cap_bf16_and_refusals(stage_b, tmp_path):
    """The captioner as shipped (bf16) captions every stored frame; a
    non-GIT captioner, a non-BERT scorer and a missing vidmapping are
    refused."""
    port = ["--platform", "cpu"]
    tgen.main(stage_b["cap"] + port)
    caps = json.load(open(os.path.join(stage_b["root"], "msvd_qa",
                                       "annotations",
                                       "frame_captions.json")))
    assert list(caps) == [str(r) for r in range(5)]
    with pytest.raises(ValueError, match="GIT"):
        tgen.main(stage_b["base"] + ["--task", "gen_cap", "--vlm_model",
                                     "Salesforce/blip"] + port)
    with pytest.raises(ValueError, match="BERT"):
        tgen.main(stage_b["inds"] + ["--sim_model", "gpt2-qa"] + port)
    with pytest.raises(FileNotFoundError, match="vidmapping"):
        tgen.main(stage_b["inds"] + ["--h5_path", "nowhere"] + port)


def test_msrvtt_ids_equal_jax(stage_b, tmp_path):
    """msrvtt_qa keys its samples by an integer ``video_id`` of files
    ``video<id>.*``: the same winds as the JAX tool."""
    adir = tmp_path / "msrvtt_qa" / "annotations"
    hdir = tmp_path / "msrvtt_qa" / "proc"
    adir.mkdir(parents=True)
    hdir.mkdir(parents=True)
    caps = stage_b["port"]["frame_captions.json"]
    json.dump(caps, open(adir / "frame_captions.json", "w"))
    json.dump({f"video{7 + r}": r for r in range(5)},
              open(hdir / "vidmapping.json", "w"))
    json.dump([{"question": f"what is in video {v}?", "answer": "cat",
                "video_id": 7 + (v * 3) % 5} for v in range(6)],
              open(adir / "qa_train.json", "w"))
    argv = (["--dataset", "msrvtt_qa", "--dataset_root", str(tmp_path)]
            + stage_b["inds"][2:])
    jgen.main(argv)
    want = json.load(open(adir / "qa_winds_train.json"))
    tgen.main(argv + ["--platform", "cpu"])
    assert json.load(open(adir / "qa_winds_train.json")) == want
