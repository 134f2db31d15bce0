"""The port's CUDA kernels on the card (skipped without a GPU).

Run on a GPU machine with:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from sasvqa_torch.models.layers import split_heads
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference)

pytestmark = pytest.mark.cuda

# same tolerances as chip_smoke.py (bf16 O, f32 LSE)
TOL_O, TOL_LSE = 2e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mask(b, l, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l + 1, size=b)
    return torch.from_numpy(
        (np.arange(l)[None, :] < lens[:, None]).astype(np.int32))


@pytest.mark.parametrize("b,h,num_img,l", [(1, 2, 1, 5), (2, 3, 65, 3),
                                           (3, 2, 591, 13), (1, 1, 640, 64)])
def test_kernel_matches_plain_on_split_head_views(cuda, b, h, num_img, l):
    s, d = num_img + l, 64
    gen = torch.Generator(device=cuda).manual_seed(num_img)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=cuda
                      ).to(torch.bfloat16)
    q, k, v = (split_heads(x, h) for x in qkv.chunk(3, dim=-1))
    mask = _mask(b, l, num_img).to(cuda)
    _build.reset_launch_counts()
    out, lse = git_flash_attention(q, k, v, mask, num_img)
    ref_o, ref_lse = git_flash_attention_reference(q, k, v, mask, num_img)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_fwd"] == 1
    assert out.shape == (b, h, s, d) and lse.shape == (b, h, s)
    assert (out.float() - ref_o.float()).abs().max().item() <= TOL_O
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 1, 70, 64), device=cuda, dtype=torch.bfloat16)
    mask = torch.ones((1, 6), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16"):
        git_flash_attention(q.float(), q.float(), q.float(), mask, 64)
    q32 = torch.zeros((1, 1, 70, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh=64"):
        git_flash_attention(q32, q32, q32, mask, 64)
    with pytest.raises(ValueError, match="does not fit"):
        git_flash_attention(q, q, q, mask, 60)
