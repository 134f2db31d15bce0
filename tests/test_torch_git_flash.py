"""Port git-flash (plain versions on the CPU) vs the JAX package's Pallas
kernels in interpret mode, its dense-bias path and its hash dropout, in
f32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sasvqa_tpu.models.git import git_attention_bias as jax_git_bias
from sasvqa_tpu.ops import git_flash as jgf

from sasvqa_torch.models.git import git_attention_bias
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import _plain_attention
from sasvqa_torch.ops.git_flash import (dense_attention_with_hash_dropout,
                                        git_flash_attention,
                                        git_flash_attention_reference,
                                        hash_dropout_factor)

from _torch_parity import to_torch

# the JAX kernel test's own tolerance (tests/test_git_flash.py)
ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jgf.set_interpret_mode(True)
    yield
    jgf.set_interpret_mode(False)


def _inputs(num_img, l, b=2, h=2, d=64, seed=0):
    s = num_img + l
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, l), np.int32)
    mask[0, -5:] = 0        # padding on example 0
    mask[1, l // 2:] = 0    # half the text padded on example 1
    return q, k, v, mask


@pytest.mark.parametrize("num_img,l", [(128, 24), (197, 30), (640, 64)])
def test_reference_matches_jax_kernel(num_img, l):
    q, k, v, mask = _inputs(num_img, l)
    s = num_img + l
    bq, bk = jgf._choose_blocks(s, q.shape[-1], fwd_only=True)
    jout, res = jgf._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), jnp.zeros((1,), jnp.int32),
                             num_img, bq, bk)
    jlse = np.asarray(res[5]).reshape(q.shape[0], q.shape[1], -1)[..., :s]

    out, lse = git_flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                   to_torch(mask), num_img)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL, rtol=RTOL)
    assert out.shape == q.shape and lse.shape == q.shape[:3]


@pytest.mark.parametrize("num_img,l", [(128, 24), (197, 30), (640, 64)])
def test_reference_matches_dense_bias_path(num_img, l):
    q, k, v, mask = _inputs(num_img, l, seed=1)
    tq, tk, tv, tm = to_torch(q), to_torch(k), to_torch(v), to_torch(mask)
    out, lse = git_flash_attention_reference(tq, tk, tv, tm, num_img)
    bias = git_attention_bias(num_img, tm)
    dense = _plain_attention(tq, tk, tv, bias)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL,
                               rtol=RTOL)
    scores = torch.matmul(tq, tk.transpose(-1, -2)) * 64 ** -0.5 + bias
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(scores, dim=-1).numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("num_img,l", [(5, 7), (197, 30), (394, 20)])
def test_git_attention_bias_bit_equal(num_img, l):
    rng = np.random.default_rng(num_img)
    mask = (rng.random((3, l)) < 0.7).astype(np.int32)
    mask[:, 0] = 1
    ours = git_attention_bias(num_img, to_torch(mask)).numpy()
    ref = np.asarray(jax_git_bias(num_img, jnp.asarray(mask)))
    np.testing.assert_array_equal(ours, ref)


def test_cpu_tensors_take_plain_path_and_count_nothing():
    q, k, v, mask = _inputs(128, 24)
    _build.reset_launch_counts()
    out, _ = git_flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                 to_torch(mask), 128)
    ref, _ = git_flash_attention_reference(to_torch(q), to_torch(k),
                                           to_torch(v), to_torch(mask), 128)
    assert torch.equal(out, ref)
    assert _build.launch_counts["git_flash_fwd"] == 0


def test_dropout_rate_raises():
    """The JAX entry's rules: rate > 0 needs a seed, rate lies in [0, 1)."""
    q, k, v, mask = _inputs(128, 24)
    args = (to_torch(q), to_torch(k), to_torch(v), to_torch(mask), 128)
    with pytest.raises(ValueError, match="seed"):
        git_flash_attention(*args, rate=0.1)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="not in"):
            git_flash_attention(*args, rate=rate, seed=3)


@pytest.mark.parametrize("l", [1, 7, 30])
def test_attention_biases_bit_equal(l):
    from sasvqa_tpu.ops import attention as jatt
    from sasvqa_torch.ops import attention as tatt
    mask = (np.random.default_rng(l).random((3, l)) < 0.6).astype(np.int32)
    np.testing.assert_array_equal(
        tatt.padding_bias(to_torch(mask)).numpy(),
        np.asarray(jatt.padding_bias(jnp.asarray(mask))))
    np.testing.assert_array_equal(tatt.causal_bias(l).numpy(),
                                  np.asarray(jatt.causal_bias(l)))


def test_dense_attention_matches_xla_path():
    from sasvqa_tpu.ops import attention as jatt
    from sasvqa_torch.ops import attention as tatt
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 3, 600, 16)).astype(np.float32)
               for _ in range(3))
    bias = np.asarray(jatt.causal_bias(600))
    ref = np.asarray(jatt._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(bias)))
    # lengths >= 512 on CPU tensors stay on the plain path
    out = tatt.dot_product_attention(to_torch(q), to_torch(k), to_torch(v),
                                     bias=to_torch(bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-5)
    # use_flash=True on CPU tensors runs the plain version of the flash
    # kernels (K5), which sums in another order
    flash = tatt.dot_product_attention(to_torch(q), to_torch(k),
                                       to_torch(v), bias=to_torch(bias),
                                       use_flash=True)
    np.testing.assert_allclose(flash.numpy(), ref, atol=2e-5, rtol=1e-4)


# ---- K4 hash dropout and the training path (forward and backward) ---------

# the JAX kernel tests' gradient tolerance (tests/test_git_flash.py)
GRAD_ATOL, GRAD_RTOL = 5e-5, 2e-4


@pytest.mark.parametrize("seed", [0, 1, -1, 123456789, -987654321,
                                  -2 ** 31, -2 ** 31 + 5, 2 ** 31 - 1,
                                  2 ** 31 - 17])
def test_hash_dropout_factor_bit_equal(seed):
    """The port's uint32 emulation gives the JAX int32 hash bit for bit,
    seeds at and near both int32 ends included."""
    for b, h, s, rate in [(1, 1, 7, 0.1), (2, 3, 33, 0.25), (3, 2, 64, 0.5),
                          (1, 2, 130, 0.9)]:
        ours = hash_dropout_factor(b, h, s, seed, rate).numpy()
        ref = np.asarray(jgf.hash_dropout_factor(b, h, s, jnp.int32(seed),
                                                 rate))
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == np.float32


def test_hash_dropout_factor_tensor_seed_matches_int_seed():
    t = hash_dropout_factor(2, 2, 40, torch.tensor([-7], dtype=torch.int32),
                            0.3)
    assert torch.equal(t, hash_dropout_factor(2, 2, 40, -7, 0.3))


def _grads_of(fn, *xs):
    xs = [to_torch(x).requires_grad_(True) for x in xs]
    out = fn(*xs)
    (out.float() ** 2).mean().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def test_dense_attention_with_hash_dropout_matches_jax():
    num_img, l = 40, 12
    q, k, v, mask = _inputs(num_img, l, d=16, seed=3)
    bias = jax_git_bias(num_img, jnp.asarray(mask))
    rate, seed = 0.3, 77

    def jfn(q, k, v):
        return jgf.dense_attention_with_hash_dropout(q, k, v, bias,
                                                     jnp.int32(seed), rate)

    jout = np.asarray(jfn(q, k, v))
    jgrads = jax.grad(lambda *a: (jfn(*a).astype(jnp.float32) ** 2).mean(),
                      argnums=(0, 1, 2))(q, k, v)
    out, grads = _grads_of(
        lambda q, k, v: dense_attention_with_hash_dropout(
            q, k, v, to_torch(np.asarray(bias)), seed, rate), q, k, v)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=RTOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_flash_forward_backward_match_jax_kernels(fused, rate, monkeypatch):
    """The plain forward and backward against the JAX Pallas kernels in
    interpret mode, for both JAX backward formulations; num_img=256 with
    128-blocks covers the JAX kernels' mask-free prefix, B=2 x H=2 the
    (b*H + h) hash coordinate."""
    monkeypatch.setattr(jgf, "FUSED_BWD", fused)
    num_img, l = 256, 32
    q, k, v, mask = _inputs(num_img, l, seed=5)
    seed = -12345

    def jfn(q, k, v):
        return jgf.git_flash_attention(q, k, v, jnp.asarray(mask), num_img,
                                       128, 128, dropout_rate=rate,
                                       dropout_seed=jnp.int32(seed))

    jout = np.asarray(jfn(q, k, v))
    jgrads = jax.grad(lambda *a: (jfn(*a).astype(jnp.float32) ** 2).mean(),
                      argnums=(0, 1, 2))(q, k, v)
    out, grads = _grads_of(
        lambda q, k, v: git_flash_attention(q, k, v, to_torch(mask),
                                            num_img, rate=rate,
                                            seed=seed if rate else None)[0],
        q, k, v)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=RTOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_flash_dropout_matches_dense_hash_dropout():
    """Forward and gradients of the git-flash plain versions with dropout
    equal the dense hash-dropout attention under the GIT bias."""
    num_img, l = 70, 9
    q, k, v, mask = _inputs(num_img, l, seed=8)
    tm = to_torch(mask)
    bias = git_attention_bias(num_img, tm)
    rate, seed = 0.4, 2 ** 31 - 3
    out_f, g_f = _grads_of(lambda q, k, v: git_flash_attention(
        q, k, v, tm, num_img, rate=rate, seed=seed)[0], q, k, v)
    out_d, g_d = _grads_of(lambda q, k, v: dense_attention_with_hash_dropout(
        q, k, v, bias, seed, rate), q, k, v)
    np.testing.assert_allclose(out_f, out_d, atol=ATOL, rtol=RTOL)
    for a, b in zip(g_f, g_d):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_cpu_backward_counts_nothing_and_leaves_lse_undifferentiable():
    q, k, v, mask = _inputs(20, 6)
    xs = [to_torch(x).requires_grad_(True) for x in (q, k, v)]
    _build.reset_launch_counts()
    out, lse = git_flash_attention(*xs, to_torch(mask), 20, rate=0.2, seed=1)
    assert not lse.requires_grad
    out.sum().backward()
    assert all(x.grad is not None for x in xs)
    assert not any(_build.launch_counts.values())


# ---- K3: the split backward and the backward route --------------------------

@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_split_backward_matches_jax_split_kernels(rate, monkeypatch):
    """FUSED_BWD=False in both packages: the port's split plain backward
    against the JAX _dq_kernel/_dkv_kernel in interpret mode, with
    num_img = 200 off the 128-block grid (a key block and a query block
    that straddle the image/text boundary) and text padding."""
    from sasvqa_torch.ops import git_flash as tgf
    monkeypatch.setattr(jgf, "FUSED_BWD", False)
    monkeypatch.setattr(tgf, "FUSED_BWD", False)
    num_img, l = 200, 24
    q, k, v, mask = _inputs(num_img, l, seed=9)
    do = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    seed = 4321

    def jfn(q, k, v):
        return jgf.git_flash_attention(q, k, v, jnp.asarray(mask), num_img,
                                       128, 128, dropout_rate=rate,
                                       dropout_seed=jnp.int32(seed))

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    xs = [to_torch(x).requires_grad_(True) for x in (q, k, v)]
    out, _ = git_flash_attention(*xs, to_torch(mask), num_img, rate=rate,
                                 seed=seed if rate else None)
    out.backward(to_torch(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=RTOL)
    for x, jg in zip(xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("flag,cross,cross_drop,rate,split", [
    (False, None, None, 0.0, True),       # the flag: K3 everywhere
    (False, None, None, 0.3, True),
    (True, None, None, 0.0, False),       # no crossover: K2 everywhere
    (True, None, None, 0.3, False),
    (True, 100, None, 0.0, True),         # S = 120 at or past the crossover
    (True, 100, None, 0.3, False),        # the rate picks its own constant
    (True, None, 121, 0.3, False),        # S = 120 below it
    (True, None, 120, 0.3, True),
])
def test_backward_route_follows_flag_and_crossover(monkeypatch, flag, cross,
                                                   cross_drop, rate, split):
    """On CPU tensors the route picks the plain version of the kernel it
    would launch on the card: the split one (K3) or the fused one (K2)."""
    from sasvqa_torch.ops import git_flash as tgf
    monkeypatch.setattr(tgf, "FUSED_BWD", flag)
    monkeypatch.setattr(tgf, "_SPLIT_MIN_SEQ", cross)
    monkeypatch.setattr(tgf, "_SPLIT_MIN_SEQ_DROPOUT", cross_drop)
    called = []
    for name in ("git_flash_backward_reference",
                 "git_flash_backward_split_reference"):
        real = getattr(tgf, name)
        monkeypatch.setattr(tgf, name, lambda *a, _r=real, _n=name: (
            called.append(_n), _r(*a))[1])
    q, k, v, mask = _inputs(100, 20, seed=2)
    assert tgf._fused_eligible(120, rate) is (not split)
    xs = [to_torch(x).requires_grad_(True) for x in (q, k, v)]
    out, _ = git_flash_attention(*xs, to_torch(mask), 100, rate=rate,
                                 seed=5 if rate else None)
    out.sum().backward()
    assert called == ["git_flash_backward_split_reference" if split
                      else "git_flash_backward_reference"]


# (num_img, L, block_m, block_n): K1's tiles, the serving and training
# shapes, and num_img on either side of a key-tile boundary
@pytest.mark.parametrize("num_img,l,bm,bn", [
    (1576, 32, 64, 64), (1576, 20, 64, 128), (128, 5, 64, 64),
    (129, 40, 64, 128), (127, 70, 64, 128), (1, 5, 64, 128),
    (200, 100, 32, 64), (64, 130, 64, 32)])
def test_k1_tile_plan_covers_every_attended_pair(num_img, l, bm, bn):
    """Every attended (row, col) lies in a key tile its query tile
    visits, and every key tile that skips the mask code is attendable
    from every row of its query tile (``git_mask_ok``)."""
    from sasvqa_torch.ops.git_flash import fwd_tile_plan, git_mask_ok
    s = num_img + l
    rng = np.random.default_rng(num_img + l)
    lens = rng.integers(1, l + 1, size=3)
    lens[0] = l
    mask = torch.from_numpy(
        (np.arange(l)[None, :] < lens[:, None]).astype(np.int32))
    ok = git_mask_ok(num_img, mask).numpy()             # (B, S, S)
    plan = fwd_tile_plan(num_img, s, bm, bn)
    assert sorted(plan) == list(range(0, s, bm))
    visited = np.zeros((s, s), bool)
    for q0, tiles in plan.items():
        rows = slice(q0, min(q0 + bm, s))
        for k0, masked in tiles:
            assert k0 < s and k0 % bn == 0
            visited[rows, k0:k0 + bn] = True
            if not masked:
                assert ok[:, rows, k0:k0 + bn].all(), (q0, k0)
    assert not (ok & ~visited[None]).any()
    # the training shape's unmasked image prefix: 24 of the 25 key tiles
    # an image-row query tile visits
    if (num_img, l, bm, bn) == (1576, 32, 64, 64):
        assert [m for _, m in plan[0]] == [False] * 24 + [True]
        assert plan == fwd_tile_plan(num_img, s)   # K1's own tiles
