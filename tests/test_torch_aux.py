"""MLM masking and MetaLoader of the port vs the JAX package on the CPU:
the host masking and the ratio interleaver give the JAX package's
results under the same numpy Generator, the torch masking core fed the
JAX function's own draws gives its output bit for bit, and the torch
masking's proportions sit inside binomial bounds (tests/test_aux.py's
cases)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.data import mlm as jmlm
from sasvqa_tpu.data.pipeline import MetaLoader as JMetaLoader

from sasvqa_torch.data import mlm as tmlm
from sasvqa_torch.data.pipeline import MetaLoader as TMetaLoader

VOCAB, MASK_ID = 100, 4


def _ids_and_special(seed, b=8, l=64):
    ids = np.random.default_rng(seed).integers(5, VOCAB, size=(b, l))
    special = np.zeros((b, l), np.int32)
    special[:, 0] = 1          # CLS never masked
    special[::3, -1] = 1
    return ids, special


@pytest.mark.parametrize("seed,prob", [(0, 0.15), (1, 0.15), (2, 0.4)])
def test_mask_tokens_numpy_matches_jax(seed, prob):
    ids, special = _ids_and_special(seed)
    want = jmlm.mask_tokens_numpy(np.random.default_rng(seed), ids, MASK_ID,
                                  VOCAB, special, prob)
    got = tmlm.mask_tokens_numpy(np.random.default_rng(seed), ids, MASK_ID,
                                 VOCAB, special, prob)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tmlm.IGNORE == jmlm.IGNORE == -100


@pytest.mark.parametrize("seed,prob", [(0, 0.15), (3, 0.5)])
def test_mask_core_on_jax_draws_is_bit_equal(seed, prob):
    """mask_tokens_jax's own draws (its key split into u, u2, rand_tok)
    through the torch core give its output exactly."""
    ids, special = _ids_and_special(seed)
    key = jax.random.key(seed)
    want_out, want_labels = jmlm.mask_tokens_jax(
        key, jnp.asarray(ids), MASK_ID, VOCAB, jnp.asarray(special), prob)
    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.uniform(k1, ids.shape)
    u2 = jax.random.uniform(k2, ids.shape)
    rand_tok = jax.random.randint(k3, ids.shape, 0, VOCAB)
    out, labels = tmlm.mask_tokens_from_draws(
        torch.from_numpy(ids), torch.from_numpy(np.asarray(u)),
        torch.from_numpy(np.asarray(u2)),
        torch.from_numpy(np.asarray(rand_tok)), MASK_ID,
        torch.from_numpy(special), prob)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


def _within(count, n, p, sigmas=5.0):
    return abs(count - n * p) <= sigmas * math.sqrt(n * p * (1 - p))


def test_mask_tokens_torch_proportions():
    """Under a torch.Generator: 15% of the maskable positions selected,
    80% of those [MASK], 10% left as they were, each within 5 binomial
    standard deviations; special positions never selected; labels hold
    the original ids; unselected ids unchanged."""
    b, l = 64, 128
    ids_np, special_np = _ids_and_special(7, b, l)
    ids, special = torch.from_numpy(ids_np), torch.from_numpy(special_np)
    gen = torch.Generator().manual_seed(0)
    out, labels = tmlm.mask_tokens(gen, ids, MASK_ID, VOCAB, special)
    sel = labels != tmlm.IGNORE
    maskable = int((special == 0).sum())
    assert not sel[special == 1].any()
    assert _within(int(sel.sum()), maskable, 0.15)
    n_sel = int(sel.sum())
    assert _within(int((out[sel] == MASK_ID).sum()), n_sel, 0.8)
    # kept: the unchanged 10% plus random draws that hit the same id
    kept = int((out[sel] == ids[sel]).sum())
    assert _within(kept, n_sel, 0.1 + 0.1 / VOCAB)
    assert torch.equal(labels[sel], ids[sel])
    assert torch.equal(out[~sel], ids[~sel])
    # the same generator seed gives the same masking
    again = tmlm.mask_tokens(torch.Generator().manual_seed(0), ids, MASK_ID,
                             VOCAB, special)
    assert torch.equal(again[0], out) and torch.equal(again[1], labels)


def _streams(prefix):
    def stream(name):
        i = 0
        while True:
            yield f"{prefix}-{name}-{i}"
            i += 1
    return stream


@pytest.mark.parametrize("ratios", [None, {"mlm": 3, "itm": 1, "vqa": 0.5}])
def test_meta_loader_matches_jax(ratios):
    """The same (task, batch) sequence as the JAX MetaLoader for 200 draws
    from the same seed, with ratios and with plain iterators."""
    names = ("mlm", "itm", "vqa")

    def loaders(prefix):
        stream = _streams(prefix)
        if ratios is None:
            return {n: stream(n) for n in names}
        return {n: (stream(n), ratios[n]) for n in names}

    jl = JMetaLoader(loaders("b"), np.random.default_rng(5))
    tl = TMetaLoader(loaders("b"), np.random.default_rng(5))
    want = [next(jl) for _ in range(200)]
    got = [next(tl) for _ in range(200)]
    assert got == want
    assert len({t for t, _ in got}) == 3
    with pytest.raises(ValueError, match="at least one"):
        TMetaLoader({}, np.random.default_rng(0))
