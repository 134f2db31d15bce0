"""The port's CUDA kernels on the card (skipped without a GPU).

Run on a GPU machine with:
    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from sasvqa_torch.models.layers import merge_heads, split_heads
from sasvqa_torch.ops import _build
from sasvqa_torch.ops.git_flash import (git_flash_attention,
                                        git_flash_attention_reference,
                                        git_flash_backward_reference)

pytestmark = pytest.mark.cuda

# same tolerances as chip_smoke.py (bf16 O, f32 LSE; bf16 gradients
# relative to each gradient's largest magnitude)
TOL_O, TOL_LSE = 2e-2, 1e-3
TOL_GRAD_REL = 2.0 ** -6

SHAPES = [(1, 2, 1, 5), (2, 3, 65, 3), (3, 2, 591, 13), (1, 1, 640, 64)]


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


@pytest.mark.parametrize("b,h,num_img,l", SHAPES)
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


def _qkv(cuda, b, h, num_img, l, seed, requires_grad=False):
    s, d = num_img + l, 64
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=cuda
                      ).to(torch.bfloat16).requires_grad_(requires_grad)
    q, k, v = (split_heads(x, h) for x in qkv.chunk(3, dim=-1))
    return qkv, q, k, v


@pytest.mark.parametrize("b,h,num_img,l", SHAPES)
def test_dropout_forward_matches_plain(cuda, b, h, num_img, l):
    _, q, k, v = _qkv(cuda, b, h, num_img, l, seed=l)
    mask = _mask(b, l, num_img).to(cuda)
    seed = torch.tensor([-(2 ** 31) + num_img], dtype=torch.int32,
                        device=cuda)
    _build.reset_launch_counts()
    out, lse = git_flash_attention(q, k, v, mask, num_img, rate=0.1,
                                   seed=seed)
    ref_o, ref_lse = git_flash_attention_reference(q, k, v, mask, num_img,
                                                   rate=0.1, seed=seed)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_fwd"] == 1
    assert _build.launch_counts["hash_dropout"] == 1
    assert (out.float() - ref_o.float()).abs().max().item() <= TOL_O
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("b,h,num_img,l", SHAPES)
def test_backward_matches_plain(cuda, b, h, num_img, l, rate):
    """K2 through autograd on split-head views of one fused QKV tensor,
    with dO arriving through merge_heads' backward as a strided view."""
    qkv, q, k, v = _qkv(cuda, b, h, num_img, l, seed=num_img,
                        requires_grad=True)
    mask = _mask(b, l, l).to(cuda)
    seed = 1234 + l
    gen = torch.Generator(device=cuda).manual_seed(7)
    dctx = torch.randn((b, num_img + l, h * 64), generator=gen,
                       device=cuda).to(torch.bfloat16)
    _build.reset_launch_counts()
    out, lse = git_flash_attention(q, k, v, mask, num_img, rate=rate,
                                   seed=seed)
    merge_heads(out).backward(dctx)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_bwd"] == 1
    do = split_heads(dctx, h)
    refs = git_flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                        out.detach(), lse, do, mask,
                                        num_img, rate, seed)
    grads = [split_heads(g, h) for g in qkv.grad.chunk(3, dim=-1)]
    for name, got, ref in zip("qkv", grads, refs):
        assert torch.isfinite(got.float()).all(), name
        scale = max(ref.float().abs().max().item(), 1e-6)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL_GRAD_REL * scale, (name, err, scale)


def _dh64_git():
    from sasvqa_torch.models.git import GITConfig, GITForCausalLM
    from sasvqa_torch.models.presets import TINY_VISION
    cfg = GITConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256,
                    max_position_embeddings=64, attention_dropout=0.0,
                    vision=dataclasses.replace(TINY_VISION, image_size=64,
                                               patch_size=8))
    return cfg, GITForCausalLM


def test_kernel_route_backward_reaches_every_text_layer(cuda):
    """Training forward/backward on the git-flash route (Dh=64, 8 frames
    of 65 tokens): every text layer's qkv.weight gets a nonzero gradient
    through K2, and the gradients agree with the dense route's."""
    cfg, cls = _dh64_git()
    rng = np.random.default_rng(0)
    b, t, l = 2, 8, 12
    ids = torch.from_numpy(rng.integers(5, 500, (b, l))).long().to(cuda)
    mask = torch.ones_like(ids)
    mask[1, 9:] = 0
    px = torch.from_numpy(rng.normal(size=(b, t, 64, 64, 3)).astype(
        np.float32)).to(cuda)
    grads = {}
    for route in (True, False):
        model = cls(cfg, dtype=torch.bfloat16, flash=route,
                    generator=torch.Generator().manual_seed(0)).to(cuda)
        _build.reset_launch_counts()
        loss = model(ids, mask, px, labels=ids, deterministic=False,
                     generator=torch.Generator(device=cuda).manual_seed(1)
                     )["loss"]
        loss.backward()
        torch.cuda.synchronize()
        expected = cfg.num_layers if route else 0
        assert _build.launch_counts["git_flash_fwd"] == expected
        assert _build.launch_counts["git_flash_bwd"] == expected
        grads[route] = {n: p.grad.float() for n, p in model.named_parameters()}
        for lyr in model.layers:
            g = lyr.attention.qkv.weight.grad
            assert g is not None and g.abs().sum().item() > 0
    for name, g in grads[True].items():
        ref = grads[False][name]
        rel = ((g - ref).norm() / ref.norm().clamp(min=1e-12)).item()
        assert rel <= 5e-2, (name, rel)


def test_scan_train_step_on_the_card(cuda):
    from sasvqa_torch.data.pipeline import stack_microbatches
    from sasvqa_torch.train.steps import (create_train_state,
                                          make_scan_train_step)
    cfg, cls = _dh64_git()
    cfg = dataclasses.replace(cfg, attention_dropout=0.1)
    model = cls(cfg, dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    micros = [{"text_input_ids": rng.integers(5, 500, (2, 12)),
               "text_attention_mask": np.ones((2, 12), np.int64),
               "visual_inputs": rng.normal(size=(2, 8, 64, 64, 3)).astype(
                   np.float32),
               "labels": rng.integers(5, 500, (2, 12))} for _ in range(4)]
    state = create_train_state(model, {"learning_rate": 1e-3,
                                       "grad_norm": 5.0}, 10)
    step = make_scan_train_step(2)
    _build.reset_launch_counts()
    losses = []
    for batch in stack_microbatches(iter(micros), 2):
        state, metrics = step(state, batch, 0)
        losses.append(metrics["loss"].item())
    assert state.step == 4 and all(np.isfinite(losses))
    assert _build.launch_counts["git_flash_bwd"] == cfg.num_layers * 4
    assert _build.launch_counts["hash_dropout"] == 2 * cfg.num_layers * 4
