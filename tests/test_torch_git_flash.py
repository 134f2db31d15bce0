"""Port git-flash (plain version on the CPU) vs the JAX package's Pallas
kernel in interpret mode and its dense-bias path, in f32."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sasvqa_tpu.models.git import git_attention_bias as jax_git_bias
from sasvqa_tpu.ops import git_flash as jgf

from sasvqa_torch.models.git import git_attention_bias
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import _plain_attention
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference)

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
    q, k, v, mask = _inputs(128, 24)
    with pytest.raises(NotImplementedError, match="K4"):
        git_flash_attention(to_torch(q), to_torch(k), to_torch(v),
                            to_torch(mask), 128, rate=0.1)


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
    with pytest.raises(NotImplementedError, match="K5"):
        tatt.dot_product_attention(to_torch(q), to_torch(k), to_torch(v),
                                   use_flash=True)
