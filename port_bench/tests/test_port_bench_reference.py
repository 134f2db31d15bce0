"""The plain references against the program's CPU path at tiny widths,
in f32: the same checkpoint file, the same inputs and the same dropout
draws give the same loss, gradients and logits.  Also the frozen copies:
the store generator against the program's scale-store tool, the
vocabulary's tokenization against the program's WordPiece, the dropout
hash against the program's."""

import os

import numpy as np
import pytest
import torch

from port_bench import store, vocab, weights
from port_bench.families import git_names
from port_bench.reference import common
from port_bench.reference import git as ref_git
from port_bench.reference import hashdrop
from port_bench.reference import text as ref_text
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def tiny_git(tmp_path_factory):
    from sasvqa_torch.models.presets import (build_model,
                                             load_pretrained_params)
    c = tiny.tiny_git_config()
    root = str(tmp_path_factory.mktemp("ckpt"))
    sd = weights.seeded_state_dict(ref_git.hf_git_shapes(c), 3, "cpu",
                                   ref_git.is_layer_norm_weight)
    weights.write(root, sd)
    cfg = {"model": {"pretrained_model": "tiny-git",
                     "vocab_size": c["vocab_size"]}}
    family, model = build_model(cfg, dtype=torch.float32, device="cpu")
    report = load_pretrained_params(family, model, root)
    assert not report["mismatched"] and not report["missing_in_ckpt"]
    return c, model, weights.load(root, "cpu")


def _batch(c, b=3, t=2, length=10, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = c["vision_config"]["image_size"]
    pix = torch.randn((b, t, 3, img, img), generator=g)
    ids = torch.randint(5, c["vocab_size"], (b, length), generator=g)
    mask = torch.ones((b, length), dtype=torch.long)
    mask[0, 7:] = 0
    mask[1, 4:] = 0
    labels = ids.clone()
    labels[:, :3] = -100
    return pix, ids, mask, labels


def test_train_loss_and_gradients_match_the_program(tiny_git):
    c, model, W = tiny_git
    pix, ids, mask, labels = _batch(c)
    model.train()
    model.zero_grad()
    out = model(ids, mask, pix.permute(0, 1, 3, 4, 2), labels=labels,
                deterministic=False,
                generator=torch.Generator().manual_seed(11))
    out["loss"].backward()
    params = {k: v.clone().requires_grad_(True) for k, v in W.items()
              if ref_git.trainable(k)}
    loss = ref_git.train_loss(params, c, pix, ids, mask, labels,
                              torch.Generator().manual_seed(11),
                              common.Arith())
    loss.backward()
    assert float(loss) == pytest.approx(float(out["loss"]), rel=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = {n: p.grad for n, p in model.named_parameters()}
    prog = git_names.leaf_norms(grads, names)
    ref = {k: float(p.grad.double().norm()) for k, p in params.items()}
    med = float(np.median(list(ref.values())))
    for k in ref:
        assert abs(prog[k] - ref[k]) <= 1e-4 * max(ref[k], med), k


def test_eval_logits_match_the_program(tiny_git):
    c, model, W = tiny_git
    pix, ids, mask, _ = _batch(c, seed=1)
    mask[:] = 1
    model.eval()
    with torch.no_grad():
        want = model(ids, mask, pix.permute(0, 1, 3, 4, 2))["logits"]
        got = ref_git.next_token_logits(W, c, pix, ids, mask,
                                        common.Arith())
    m = want.shape[1] - ids.shape[1]
    torch.testing.assert_close(got, want[:, m:], rtol=1e-4, atol=1e-4)


def test_control_rounds_every_product():
    x = torch.randn(64, 64)
    q = common.fake_fp8(x)
    assert not torch.equal(q, x)
    rel = float((q - x).norm() / x.norm())
    assert 1e-3 < rel < 0.1      # float8's 3 mantissa bits


def test_hash_matches_the_program():
    from sasvqa_torch.ops.git_flash import hash_dropout_factor
    seed = torch.tensor([-123456789], dtype=torch.int64)
    want = hash_dropout_factor(2, 3, 17, seed.to(torch.int32), 0.1)
    got = hashdrop.factor(2, 3, 17, seed, 0.1)
    assert torch.equal(got, want)
    assert 0.05 < float((got == 0).float().mean()) < 0.15


def test_fold_in_matches_the_program():
    from sasvqa_torch.train.steps import fold_in
    for s, n in ((0, 0), (42, 7), (2 ** 40 + 3, 1000)):
        assert common.fold_in(s, n) == fold_in(s, n)


def test_store_is_the_programs_generator(tmp_path):
    from sasvqa_torch.data.frame_store import MemoryFrameStores
    from sasvqa_torch.tools.make_scale_store import make_scale_store
    counts = {"train": 30, "val": 5, "test": 5}
    mem = MemoryFrameStores()
    paths = make_scale_store(str(tmp_path), num_videos=7, k=4, img_size=8,
                             n_questions=counts, seed=5, writer=mem.writer)
    data = store.make(7, 4, 8, counts, 5)
    for split in counts:
        import json
        with open(paths[split]) as f:
            assert json.load(f) == data["annotations"][split]
    assert np.array_equal(mem.rows[paths["h5"]], data["frames"])


def test_tokenization_matches_the_programs_wordpiece(tmp_path):
    from sasvqa_torch.data.tokenization import WordPieceTokenizer
    root = vocab.write(str(tmp_path), 2048, store.words())
    tok = WordPieceTokenizer.from_vocab_file(os.path.join(root,
                                                          "vocab.txt"))
    v = ref_text.read_vocab(os.path.join(root, "vocab.txt"))
    data = store.make(3, 2, 4, {"train": 40}, 9)
    for a in data["annotations"]["train"]:
        assert ref_text.git_prompt(v, a["question"]) == \
            [tok.cls_token_id] + tok.encode(a["question"],
                                            add_special_tokens=False)
        ids, mask, labels = ref_text.git_train_row(v, a["question"],
                                                   a["answer"], 12)
        assert tok.unk_token_id not in ids.tolist()
        assert labels[:1 + len(ref_text.words(a["question"]))].tolist() \
            == [-100] * (1 + len(ref_text.words(a["question"])))
