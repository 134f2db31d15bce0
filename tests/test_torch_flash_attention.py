"""The port's generic flash attention (K5/K6 plain versions, the autograd
function and the dot_product_attention route) against the JAX package's
Pallas flash_attention in interpret mode, on seeded numpy inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sasvqa_tpu.ops import attention as jatt
from sasvqa_tpu.ops import flash_attention as jfa

import torch

from sasvqa_torch.ops import _build
from sasvqa_torch.ops import attention as tatt
from sasvqa_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_backward_reference)

from _torch_parity import to_torch

# f32: the Pallas kernel sums blockwise with an online softmax, the plain
# version in one pass; the JAX flash tests' tolerance
ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.set_interpret_mode(True)
    yield
    jfa.set_interpret_mode(False)


def _bias(kind, b, h, lq, lk, seed):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "row":          # key padding, (B, 1, 1, Lk)
        keep = (np.arange(lk)[None, :]
                < rng.integers(lk // 2, lk + 1, size=b)[:, None])
        return np.asarray(jatt.padding_bias(jnp.asarray(keep.astype(
            np.int32))))
    if kind == "causal":       # (1, 1, L, L)
        return np.asarray(jatt.causal_bias(lq))
    return rng.normal(size=(b, 1, lq, lk)).astype(np.float32)  # 2-D


CASES = {  # name: (B, H, Lq, Lk, Dh, bias, dtype)
    "no_bias_577": (1, 2, 577, 577, 16, None, np.float32),
    "row_bias_130x200": (2, 2, 130, 200, 16, "row", np.float32),
    "causal_256": (1, 2, 256, 256, 16, "causal", np.float32),
    "bias_2d_200x130": (2, 2, 200, 130, 16, "2d", np.float32),
    "bf16_row_130x200": (1, 2, 130, 200, 64, "row", jnp.bfloat16),
}


def _inputs(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    g = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    return q, k, v, g


def _close(ours, ref, bf16, name):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, dtype=np.float32)
    if bf16:
        # both compute in f32 and round once to bf16; summation order can
        # move a value across a rounding boundary: one bf16 step (2^-8
        # relative) of the largest magnitude
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max(),
                                   err_msg=name)
    else:
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_and_backward_match_pallas(case):
    """O, the f32 LSE, and dQ/dK/dV through the port's autograd function
    (CPU tensors: the plain versions of K5 and K6) equal the Pallas
    forward and backward; the 2-D bias also gets its cotangent."""
    b, h, lq, lk, d, kind, dt = CASES[case]
    bf16 = dt == jnp.bfloat16
    q, k, v, g = _inputs(b, h, lq, lk, d, seed=lq + lk)
    bias = _bias(kind, b, h, lq, lk, seed=lk)
    jq, jk, jv, jg = (jnp.asarray(x, dt) for x in (q, k, v, g))
    jb = None if bias is None else jnp.asarray(bias)
    grad_bias = kind == "2d"

    if grad_bias:
        jout, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a), jq, jk, jv,
                            jb)
        jdq, jdk, jdv, jdb = vjp(jg)
    else:
        jout, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, jb), jq, jk,
                            jv)
        jdq, jdk, jdv = vjp(jg)
    _, jlse = jfa._flash_forward(jq, jk, jv, jb, jfa.DEFAULT_BQ,
                                 jfa.DEFAULT_BK, want_lse=True)
    jlse = np.asarray(jlse)[:, 0, :lq].reshape(b, h, lq)

    tdt = torch.bfloat16 if bf16 else torch.float32
    tq, tk, tv = (to_torch(np.asarray(x, np.float32), tdt).requires_grad_()
                  for x in (jq, jk, jv))
    tb = None if bias is None else to_torch(bias).requires_grad_(grad_bias)
    _build.reset_launch_counts()
    out = flash_attention(tq, tk, tv, tb)
    out.backward(to_torch(np.asarray(jg, np.float32), tdt))
    assert not any(_build.launch_counts.values())      # CPU: plain only
    _, lse = flash_attention_reference(tq.detach(), tk.detach(),
                                       tv.detach(),
                                       None if tb is None else tb.detach())
    _close(out.detach(), jout, bf16, "O")
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=1e-5)
    for name, ours, ref in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk),
                            ("dv", tv.grad, jdv)):
        _close(ours, ref, bf16, name)
    if grad_bias:
        _close(tb.grad, jdb, bf16, "dbias")


def test_backward_reference_matches_pallas_backward():
    """flash_backward_reference from the forward's own O and LSE equals
    the Pallas _flash_backward on a row bias with ragged lengths."""
    b, h, lq, lk, d = 2, 2, 130, 200, 16
    q, k, v, g = _inputs(b, h, lq, lk, d, seed=7)
    bias = _bias("row", b, h, lq, lk, seed=8)
    jq, jk, jv, jg, jb = (jnp.asarray(x) for x in (q, k, v, g, bias))
    jo, jlse = jfa._flash_forward(jq, jk, jv, jb, 128, 128, want_lse=True)
    ref = jfa._flash_backward(jq, jk, jv, jb, jlse, jo, jg, 128, 128)
    o, lse = flash_attention_reference(*(to_torch(x) for x in (q, k, v)),
                                       to_torch(bias))
    ours = flash_backward_reference(*(to_torch(x) for x in (q, k, v)), o,
                                    lse, to_torch(g), to_torch(bias))
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        _close(a, r, False, name)


def test_fully_masked_row_gives_zeros():
    """A row whose bias is -inf everywhere has l == 0: O is 0, the LSE is
    -inf and the backward gives that row no gradient (no NaN)."""
    rng = np.random.default_rng(3)
    q, k, v = (to_torch(rng.normal(size=(1, 1, 6, 8)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    bias = torch.zeros((1, 1, 6, 6))
    bias[0, 0, 2] = float("-inf")
    out = flash_attention(q, k, v, bias)
    out.sum().backward()
    assert torch.equal(out[0, 0, 2], torch.zeros(8))
    _, lse = flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                       bias)
    assert torch.isneginf(lse[0, 0, 2]) and torch.isfinite(lse[0, 0, 3])
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()
    assert torch.equal(q.grad[0, 0, 2], torch.zeros(8))


def test_dot_product_attention_routes_like_jax():
    """CPU tensors stay plain unless use_flash=True asks for the flash
    route (its plain version then runs, equal to the dense path); a
    lower-rank bias gains leading axes on the flash route."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 3, 600, 16)).astype(np.float32)
               for _ in range(3))
    bias = np.asarray(jatt.causal_bias(600))
    ref = np.asarray(jatt._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(bias)))
    tq, tk, tv = (to_torch(x) for x in (q, k, v))
    assert not tatt._use_flash(tq, tk, None)        # CPU, >= 512: plain
    assert tatt._use_flash(tq, tk, True)
    _build.reset_launch_counts()
    flash = tatt.dot_product_attention(tq, tk, tv, bias=to_torch(bias[0, 0]),
                                       use_flash=True)
    np.testing.assert_allclose(flash.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert not any(_build.launch_counts.values())
    with pytest.raises(ValueError, match="GPU"):
        from sasvqa_torch.ops.flash_attention import _launch_fwd
        _launch_fwd(tq, tk, tv, None)
