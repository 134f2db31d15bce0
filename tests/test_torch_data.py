"""Port host data path vs the JAX package's: GITCollator (both branches,
f32 and u8 pixels), u8 dequantization, WordPiece, sampling policies."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sasvqa_tpu.core import pixels as jpixels
from sasvqa_tpu.data import dataset as jdataset
from sasvqa_tpu.data import tokenization as jtok
from sasvqa_tpu.sampling import policies as jpolicies
from sasvqa_tpu.tools.extract_frames import normalize_frames

from sasvqa_torch.core import pixels as tpixels
from sasvqa_torch.data import dataset as tdataset
from sasvqa_torch.data import tokenization as ttok
from sasvqa_torch.sampling import policies as tpolicies

from _torch_parity import frames

QUESTIONS = ["what is the man doing?", "Who plays with the red ball",
             "where is the dog running in the video frame",
             "how many cats jump on the green thing , really ?"]


def _items(n_groups=4, k=8, img=16, group=1, seed=0):
    items = []
    for i in range(n_groups):
        exs = [{"q_str": QUESTIONS[(i + j) % len(QUESTIONS)],
                "str_label": ["dog", "red", "running"][(i + j) % 3],
                "label": (i + j) % 3, "question_id": i * group + j}
               for j in range(group)]
        items.append({"vid": frames(seed + i, k, img), "examples": exs,
                      "n_examples": group})
    return items


def _assert_batches_equal(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        if ref[key] is None:
            assert ours[key] is None
        elif isinstance(ref[key], np.ndarray):
            assert ours[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(ours[key], ref[key])
        else:
            assert ours[key] == ref[key], key


@pytest.mark.parametrize("add_ans", [True, False])
@pytest.mark.parametrize("pixel_dtype", ["f32", "u8"])
@pytest.mark.parametrize("policy", ["uniform", "random"])
def test_git_collator_array_equal(add_ans, pixel_dtype, policy):
    kw = dict(max_txt_len=8, max_seq_len=10, nframe=3, samp_policy=policy,
              add_ans=add_ans, pixel_dtype=pixel_dtype)
    ref_col = jdataset.GITCollator(jtok.make_test_wordpiece(), **kw)
    our_col = tdataset.GITCollator(ttok.make_test_wordpiece(), **kw)
    items = _items(group=2)
    ref = ref_col(items, rng=np.random.default_rng(5))
    ours = our_col(items, rng=np.random.default_rng(5))
    _assert_batches_equal(ours, ref)
    assert our_col.n_truncated == ref_col.n_truncated


def test_collator_rejects_bf16_staging_and_ragged_groups():
    # bf16 staging is ported (tests/test_torch_loop_options.py holds its
    # bits to the JAX collators'); an unknown staging dtype is refused
    assert tdataset.GITCollator(ttok.make_test_wordpiece(),
                                pixel_dtype="bf16").pixel_dtype == np.uint16
    with pytest.raises(ValueError, match="unknown pixel_dtype"):
        tdataset.GITCollator(ttok.make_test_wordpiece(), pixel_dtype="bf8")
    col = tdataset.GITCollator(ttok.make_test_wordpiece(), nframe=2,
                               samp_policy="uniform")
    items = _items(n_groups=2)
    items[1] = dict(items[1], examples=items[1]["examples"] * 2,
                    n_examples=2)
    with pytest.raises(ValueError, match="non-uniform"):
        col(items)


def test_dequantize_bit_equal_on_grid():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8)
    stored = normalize_frames(u8)
    q = tpixels.quantize_u8(stored)
    np.testing.assert_array_equal(q, jpixels.quantize_u8(stored))
    np.testing.assert_array_equal(q, u8)
    ours = tpixels.dequantize(torch.from_numpy(q), torch.float32).numpy()
    ref = np.asarray(jpixels.dequantize(jnp.asarray(q), jnp.float32))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, stored)
    x = torch.ones((2, 4, 4, 3), dtype=torch.bfloat16)
    assert tpixels.maybe_dequantize(x, torch.bfloat16) is x
    assert tpixels.maybe_dequantize(torch.from_numpy(q), torch.bfloat16
                                    ).dtype == torch.bfloat16


@pytest.mark.parametrize("pair", [False, True])
def test_wordpiece_identical(pair):
    ref, ours = jtok.make_test_wordpiece(), ttok.make_test_wordpiece()
    texts = QUESTIONS + ["Ünïcödé accents, and punctuation!!", "",
                         "supercalifragilistic " * 3]
    pairs = list(reversed(texts)) if pair else None
    for max_length in (4, 12, 40):
        r = ref(texts, max_length=max_length, text_pairs=pairs)
        o = ours(texts, max_length=max_length, text_pairs=pairs)
        for key in r:
            np.testing.assert_array_equal(o[key], r[key])
    for text in texts:
        assert ours.tokenize(text) == ref.tokenize(text)
        ids = ref.encode(text, add_special_tokens=False)
        assert ours.encode(text, add_special_tokens=False) == ids
        assert ours.decode(ids) == ref.decode(ids)
        assert ours.decode(ids + [0, 2, 3]) == ref.decode(ids + [0, 2, 3])


@pytest.mark.parametrize("policy,k,nframe",
                         [("uniform", 16, 2), ("uniform", 7, 3),
                          ("random", 9, 4), ("single", 5, 1),
                          ("importance", 6, 3)])
def test_sampling_policies_identical(policy, k, nframe):
    for seed in range(3):
        ref = jpolicies.sample_indices(policy, k, nframe,
                                       rng=np.random.default_rng(seed),
                                       batch_size=4)
        ours = tpolicies.sample_indices(policy, k, nframe,
                                        rng=np.random.default_rng(seed),
                                        batch_size=4)
        np.testing.assert_array_equal(ours, ref)
    assert (tpolicies.num_output_frames(policy, k, nframe)
            == jpolicies.num_output_frames(policy, k, nframe))
