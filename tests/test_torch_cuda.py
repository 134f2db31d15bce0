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
from sasvqa_torch.ops.attention import dot_product_attention
from sasvqa_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_backward_reference)
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
    """The routed backward (K2, or K3 when FUSED_BWD is False) through
    autograd on split-head views of one fused QKV tensor, with dO arriving
    through merge_heads' backward as a strided view."""
    from sasvqa_torch.ops import git_flash as gf
    fused = gf.FUSED_BWD
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
    assert _build.launch_counts["git_flash_bwd"] == (1 if fused else 0)
    assert _build.launch_counts["git_flash_bwd_dq"] == (0 if fused else 1)
    do = split_heads(dctx, h)
    reference = (git_flash_backward_reference if fused
                 else gf.git_flash_backward_split_reference)
    refs = reference(q.detach(), k.detach(), v.detach(), out.detach(), lse,
                     do, mask, num_img, rate, seed)
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


# ---- K5 / K6: the generic flash kernels ------------------------------------

FLASH_SHAPES = [  # (B, H, Lq, Lk, bias)
    (2, 3, 577, 577, None),      # one BLIP-base frame, ragged edge tiles
    (1, 2, 130, 200, "row"),     # rectangular, key-padding row bias
    (2, 2, 200, 130, "full"),    # rectangular, per-example 2-D bias
    (1, 2, 577, 577, "causal"),  # (1, 1, L, L) causal bias
    (2, 3, 65, 64, "heads"),     # (1, H, Lq, Lk) bias
]


def _flash_bias(kind, b, h, lq, lk, cuda, seed):
    from sasvqa_torch.ops.attention import causal_bias, padding_bias
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "row":
        keep = (np.arange(lk)[None, :]
                < rng.integers(lk // 2, lk + 1, size=b)[:, None])
        return padding_bias(torch.from_numpy(keep.astype(np.int32))).to(cuda)
    if kind == "causal":
        return causal_bias(lq, device=cuda)
    shape = (b, 1, lq, lk) if kind == "full" else (1, h, lq, lk)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)


@pytest.mark.parametrize("b,h,lq,lk,kind", FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, b, h, lq, lk, kind):
    """K5's O and LSE and K6's dQ, dK, dV through autograd, on split-head
    views of fused projections, within the chip_smoke.py tolerances of
    the plain versions."""
    d = 64
    gen = torch.Generator(device=cuda).manual_seed(lq + lk)
    xq = torch.randn((b, lq, h * d), generator=gen, device=cuda
                     ).to(torch.bfloat16).requires_grad_(True)
    xkv = torch.randn((b, lk, 2 * h * d), generator=gen, device=cuda
                      ).to(torch.bfloat16).requires_grad_(True)
    q = split_heads(xq, h)
    k, v = (split_heads(x, h) for x in xkv.chunk(2, dim=-1))
    bias = _flash_bias(kind, b, h, lq, lk, cuda, lq)
    dctx = torch.randn((b, lq, h * d), generator=gen, device=cuda
                       ).to(torch.bfloat16)
    _build.reset_launch_counts()
    out = flash_attention(q, k, v, bias)
    merge_heads(out).backward(dctx)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == 1
    assert _build.launch_counts["flash_bwd_dq"] == 1
    assert _build.launch_counts["flash_bwd_dkv"] == 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref_o, ref_lse = flash_attention_reference(qd, kd, vd, bias)
    assert (out.float() - ref_o.float()).abs().max().item() <= TOL_O
    from sasvqa_torch.ops.flash_attention import flash_forward
    _, lse = flash_forward(qd, kd, vd, bias)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE
    refs = flash_backward_reference(qd, kd, vd, out.detach(), lse,
                                    split_heads(dctx, h), bias)
    grads = [split_heads(xq.grad, h)] + [
        split_heads(g, h) for g in xkv.grad.chunk(2, dim=-1)]
    for name, got, ref in zip("qkv", grads, refs):
        assert torch.isfinite(got.float()).all(), name
        scale = max(ref.float().abs().max().item(), 1e-6)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL_GRAD_REL * scale, (name, err, scale)


def test_flash_route_raises_where_the_kernels_cannot_go(cuda):
    """At >= 512 tokens CUDA tensors take the kernels or raise: Dh != 64
    and f32 inputs raise; nothing falls back to the plain version."""
    x32 = torch.zeros((1, 2, 600, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh=64"):
        dot_product_attention(x32, x32, x32)
    x = torch.zeros((1, 2, 600, 64), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        dot_product_attention(x, x, x)
    _build.reset_launch_counts()
    xb = x.to(torch.bfloat16)
    dot_product_attention(xb, xb, xb, bias=torch.zeros((600,), device=cuda))
    assert _build.launch_counts["flash_fwd"] == 1
    dot_product_attention(xb[:, :, :500], xb, xb)       # Lq < 512: plain
    assert _build.launch_counts["flash_fwd"] == 1


def test_blip_vision_tower_backward_reaches_every_layer(cuda):
    """BLIP's vision tower at 384x384 / patch 16 (577 tokens, Dh = 64) on
    the kernel route: K5 and K6 launch once a layer, every layer's
    qkv.weight gets a nonzero gradient through them, and the gradients
    agree with the plain route's (flash=False) within 5e-2 of their norm,
    or, where the plain bf16 route itself is further than that from the
    plain route in f32, are no further from f32 than twice the plain
    route (chip_smoke.py's BLIP grad-check rule)."""
    from sasvqa_torch.models.blip import BLIPVisionConfig, BLIPVisionEncoder
    # BLIP-base depth (12 layers) at a narrow width, heads of Dh = 64
    cfg = BLIPVisionConfig(hidden_size=128, intermediate_size=256,
                           num_layers=12, num_heads=2)
    px = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 384, 384, 3)).astype(np.float32)).to(cuda)
    grads = {}
    for route, dtype in ((None, torch.bfloat16), (False, torch.bfloat16),
                         (False, torch.float32)):
        model = BLIPVisionEncoder(cfg, dtype=dtype,
                                  generator=torch.Generator().manual_seed(0)
                                  ).to(cuda)
        model.flash = route
        _build.reset_launch_counts()
        hidden, pooled = model(px)
        (hidden.float().square().mean() + pooled.float().sum()).backward()
        torch.cuda.synchronize()
        expected = cfg.num_layers if route is None else 0
        assert _build.launch_counts["flash_fwd"] == expected
        assert _build.launch_counts["flash_bwd_dq"] == expected
        assert _build.launch_counts["flash_bwd_dkv"] == expected
        for lyr in model.layers:
            g = lyr.self_attn.qkv.weight.grad
            assert g is not None and g.abs().sum().item() > 0
        grads[route, dtype] = {}
        for n, p in model.named_parameters():
            g = p.grad.float()
            if n.endswith("qkv.bias"):   # the K third's true gradient is 0
                d = g.shape[0] // 3
                g = torch.cat([g[:d], g[2 * d:]])
            grads[route, dtype][n] = g

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-12)).item()

    kern = grads[None, torch.bfloat16]
    plain = grads[False, torch.bfloat16]
    oracle = grads[False, torch.float32]
    for name, g in kern.items():
        kp, pf = rel(g, plain[name]), rel(plain[name], oracle[name])
        assert kp <= 5e-2 or (pf > 5e-2 and rel(g, oracle[name]) <= 2 * pf), \
            (name, kp, pf, rel(g, oracle[name]))



# ---- K3: the split git-flash backward ---------------------------------------

SPLIT_SHAPES = [(2, 3, 65, 3), (2, 2, 591, 13)]   # (B, H, num_img, L)


def _split_inputs(cuda, b, h, num_img, l, rate):
    from sasvqa_torch.ops import git_flash as gf
    _, q, k, v = _qkv(cuda, b, h, num_img, l, seed=num_img + 1)
    mask = _mask(b, l, l + 1).to(cuda)
    seed = torch.tensor([987 + l], dtype=torch.int32, device=cuda)
    o, lse = git_flash_attention(q, k, v, mask, num_img, rate, seed)
    gen = torch.Generator(device=cuda).manual_seed(3)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(q.dtype)
    return gf, (q, k, v, o, lse, do, mask, num_img, rate, seed)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,num_img,l", SPLIT_SHAPES)
def test_split_backward_matches_plain_and_fused(cuda, b, h, num_img, l,
                                                rate):
    """K3 against its plain version (split numerics) and against K2, with
    dQ bit-identical across two launches; each kernel counts one launch
    and, at rate > 0, one dropout-hash launch (as K2 does)."""
    gf, args = _split_inputs(cuda, b, h, num_img, l, rate)
    _build.reset_launch_counts()
    got = gf._launch_bwd_split(*args)
    again = gf._launch_bwd_split(*args)
    fused = gf._launch_bwd(*args)
    ref = gf.git_flash_backward_split_reference(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_bwd_dq"] == 2
    assert _build.launch_counts["git_flash_bwd_dkv"] == 2
    # two K3 backwards of two kernels each, and one K2
    assert _build.launch_counts["hash_dropout"] == (5 if rate else 0)
    assert torch.equal(got[0], again[0])
    for name, g, f, r in zip("qkv", got, fused, ref):
        assert g.shape == r.shape and torch.isfinite(g.float()).all(), name
        scale = max(r.float().abs().max().item(), 1e-6)
        assert (g.float() - r.float()).abs().max().item() \
            <= TOL_GRAD_REL * scale, name
        assert (g.float() - f.float()).abs().max().item() \
            <= TOL_GRAD_REL * scale, name


def test_split_backward_rejects_what_it_cannot_take(cuda):
    gf, args = _split_inputs(cuda, 1, 2, 65, 3, 0.0)
    q, k, v, o, lse, do, mask, num_img, rate, seed = args
    with pytest.raises(ValueError, match="bf16"):
        gf._launch_bwd_split(q.float(), k, v, o, lse, do, mask, num_img)
    with pytest.raises(ValueError, match="LSE"):
        gf._launch_bwd_split(q, k, v, o, lse.half(), do, mask, num_img)
    with pytest.raises(ValueError, match="does not fit"):
        gf._launch_bwd_split(q, k, v, o, lse, do, mask, num_img - 1)
    with pytest.raises(ValueError, match="GPU"):
        gf._launch_bwd_split(q, k, v, o, lse, do, mask.cpu(), num_img)


def test_route_flag_sends_the_backward_through_k3(cuda, monkeypatch):
    """FUSED_BWD=False routes every CUDA backward to K3, True to K2; the
    autograd backward follows the route."""
    gf, args = _split_inputs(cuda, 2, 2, 130, 6, 0.1)
    q, k, v, o, lse, do, mask, num_img, rate, seed = args
    for flag, name in ((False, "git_flash_bwd_dq"), (True, "git_flash_bwd")):
        monkeypatch.setattr(gf, "FUSED_BWD", flag)
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        _build.reset_launch_counts()
        out, _ = git_flash_attention(*xs, mask, num_img, rate, seed)
        out.backward(do)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == 1, _build.launch_counts
        assert all(x.grad is not None for x in xs)


# ---- K1 / K5 on the Hopper tiling (64-row query tiles, 64-key tiles) -------

TILING_FLASH_SHAPES = [  # (B, H, Lq, Lk, bias): ragged edges of both tiles
    (2, 2, 577, 577, None),      # the last key tile holds one key
    (1, 2, 577, 577, "causal"),  # (1, 1, L, L)
    (2, 2, 129, 300, "row"),     # Lq < Lk, (B, 1, 1, Lk)
    (1, 3, 300, 129, "full"),    # Lq > Lk, (B, 1, Lq, Lk)
    (2, 2, 65, 200, "heads"),    # (1, H, Lq, Lk)
    (1, 2, 64, 128, None),       # whole tiles only
    (1, 1, 1, 1, None),          # one row, one key
]


def _split_head_qkv(cuda, b, h, lq, lk, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xq = torch.randn((b, lq, h * 64), generator=gen, device=cuda
                     ).to(torch.bfloat16)
    xkv = torch.randn((b, lk, 2 * h * 64), generator=gen, device=cuda
                      ).to(torch.bfloat16)
    k, v = (split_heads(x, h) for x in xkv.chunk(2, dim=-1))
    return split_heads(xq, h), k, v


@pytest.mark.parametrize("b,h,lq,lk,kind", TILING_FLASH_SHAPES)
def test_k5_tiling_edges_match_plain(cuda, b, h, lq, lk, kind):
    """K5 (wgmma/TMA) on split-head (B, L, H, Dh) views at every ragged
    edge of its tiles, one launch, within the chip_smoke.py tolerances."""
    from sasvqa_torch.ops.flash_attention import flash_forward
    q, k, v = _split_head_qkv(cuda, b, h, lq, lk, seed=lq * 1000 + lk)
    bias = _flash_bias(kind, b, h, lq, lk, cuda, lk)
    _build.reset_launch_counts()
    out, lse = flash_forward(q, k, v, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == 1
    ref_o, ref_lse = flash_attention_reference(q, k, v, bias)
    assert out.shape == (b, h, lq, 64) and lse.shape == (b, h, lq)
    assert (out.float() - ref_o.float()).abs().max().item() <= TOL_O
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


def test_k5_row_with_every_key_masked_gives_zeros(cuda):
    """A query row whose bias is -inf at every key: O is 0 and LSE is
    -inf, as in the plain version; the other rows are unaffected."""
    from sasvqa_torch.ops.flash_attention import flash_forward
    b, h, lq, lk = 2, 2, 200, 300
    q, k, v = _split_head_qkv(cuda, b, h, lq, lk, seed=5)
    bias = torch.zeros((b, 1, lq, lk), device=cuda)
    bias[:, :, 70] = float("-inf")
    bias[1, :, 199] = float("-inf")
    _build.reset_launch_counts()
    out, lse = flash_forward(q, k, v, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == 1
    ref_o, ref_lse = flash_attention_reference(q, k, v, bias)
    assert out[:, :, 70].abs().max().item() == 0.0
    assert out[1, :, 199].abs().max().item() == 0.0
    assert torch.isneginf(lse[:, :, 70]).all()
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    assert (out.float() - ref_o.float()).abs().max().item() <= TOL_O
    fin = torch.isfinite(ref_lse)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= TOL_LSE


TILING_GIT_SHAPES = [  # (B, H, num_img, L, rate): num_img about a boundary
    (2, 2, 127, 2, 0.0), (2, 2, 128, 5, 0.0), (1, 3, 129, 70, 0.0),
    (2, 2, 255, 3, 0.1), (1, 2, 256, 1, 0.1), (2, 2, 1, 200, 0.0),
    (2, 2, 564, 13, 0.1), (1, 2, 640, 64, 0.0)]


@pytest.mark.parametrize("b,h,num_img,l,rate", TILING_GIT_SHAPES)
def test_k1_tiling_edges_match_plain(cuda, b, h, num_img, l, rate):
    """K1 (wgmma/TMA) on split-head views with num_img on either side of
    a key tile boundary (the unmasked image prefix) and of a query
    tile, text-heavy sequences, and rate 0.1 with a tensor seed:
    one launch, within the chip_smoke.py tolerances."""
    _, q, k, v = _qkv(cuda, b, h, num_img, l, seed=num_img + l)
    mask = _mask(b, l, num_img + 7).to(cuda)
    seed = torch.tensor([-(2 ** 31) + 3 * num_img], dtype=torch.int32,
                        device=cuda)
    _build.reset_launch_counts()
    out, lse = git_flash_attention(q, k, v, mask, num_img, rate, seed)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_fwd"] == 1
    assert _build.launch_counts["hash_dropout"] == (1 if rate else 0)
    ref_o, ref_lse = git_flash_attention_reference(q, k, v, mask, num_img,
                                                   rate, seed)
    assert (out.float() - ref_o.float()).abs().max().item() <= TOL_O
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


# ---- K3 / K6 on the Hopper backward mainloop (64-row tiles, wgmma/TMA) -----

def _grads_close(got, ref):
    for name, g, r in zip("qkv", got, ref):
        assert g.shape == r.shape and torch.isfinite(g.float()).all(), name
        scale = max(r.float().abs().max().item(), 1e-6)
        err = (g.float() - r.float()).abs().max().item()
        assert err <= TOL_GRAD_REL * scale, (name, err, scale)


TILING_SPLIT_SHAPES = [  # (B, H, num_img, L, rate): S and num_img off tiles
    (2, 2, 127, 2, 0.0), (1, 2, 128, 5, 0.1), (1, 3, 129, 70, 0.0),
    (2, 2, 255, 3, 0.1), (2, 2, 1, 200, 0.0), (2, 2, 564, 13, 0.1),
    (1, 2, 640, 64, 0.0), (1, 1, 1, 1, 0.1)]


@pytest.mark.parametrize("b,h,num_img,l,rate", TILING_SPLIT_SHAPES)
def test_k3_tiling_edges_match_plain(cuda, b, h, num_img, l, rate):
    """K3 (wgmma/TMA) on split-head views with S and num_img on either
    side of a tile boundary (577 = 9 * 64 + 1 included), text-heavy
    sequences and rate 0.1: within the chip_smoke.py tolerance of the
    plain split backward, one launch of each program, and dQ, dK and dV
    the same bits on a second launch."""
    from sasvqa_torch.ops import git_flash as gf
    _, q, k, v = _qkv(cuda, b, h, num_img, l, seed=3 * num_img + l)
    mask = _mask(b, l, num_img + 11).to(cuda)
    seed = torch.tensor([2 ** 31 - 5 * num_img], dtype=torch.int32,
                        device=cuda)
    o, lse = git_flash_attention(q, k, v, mask, num_img, rate, seed)
    gen = torch.Generator(device=cuda).manual_seed(l)
    do = split_heads(torch.randn((b, num_img + l, h * 64), generator=gen,
                                 device=cuda).to(torch.bfloat16), h)
    args = (q, k, v, o, lse, do, mask, num_img, rate, seed)
    _build.reset_launch_counts()
    got = gf._launch_bwd_split(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_bwd_dq"] == 1
    assert _build.launch_counts["git_flash_bwd_dkv"] == 1
    assert _build.launch_counts["hash_dropout"] == (2 if rate else 0)
    again = gf._launch_bwd_split(*args)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _grads_close(got, gf.git_flash_backward_split_reference(*args))


@pytest.mark.parametrize("b,h,lq,lk,kind", TILING_FLASH_SHAPES)
def test_k6_tiling_edges_match_plain(cuda, b, h, lq, lk, kind):
    """K6 (wgmma/TMA) on split-head views at every ragged edge of its
    tiles (577 keys and queries, Lq != Lk, each bias kind, a
    rectangular row bias): within the chip_smoke.py tolerance of the
    plain backward, one launch of each program, and the same bits on a
    second launch."""
    from sasvqa_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                                  flash_forward)
    q, k, v = _split_head_qkv(cuda, b, h, lq, lk, seed=lq * 7 + lk)
    bias = _flash_bias(kind, b, h, lq, lk, cuda, lq)
    o, lse = flash_forward(q, k, v, bias)
    gen = torch.Generator(device=cuda).manual_seed(lk)
    do = split_heads(torch.randn((b, lq, h * 64), generator=gen,
                                 device=cuda).to(torch.bfloat16), h)
    runs = []
    _build.reset_launch_counts()
    for _ in range(2):
        dq, delta = _launch_dq(q, k, v, o, lse, do, bias)
        runs.append((dq,) + _launch_dkv(q, k, v, o, lse, do, bias, delta))
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_bwd_dq"] == 2
    assert _build.launch_counts["flash_bwd_dkv"] == 2
    for g, a in zip(*runs):
        assert torch.equal(g, a)
    _grads_close(runs[0], flash_backward_reference(q, k, v, o, lse, do,
                                                   bias))


def test_k6_row_with_every_key_masked_gives_zero_gradients(cuda):
    """A query row whose bias is -inf at every key (LSE -inf): its dQ is
    0 and it adds nothing to dK or dV, as in the plain version."""
    from sasvqa_torch.ops.flash_attention import flash_backward, flash_forward
    b, h, lq, lk = 2, 2, 200, 300
    q, k, v = _split_head_qkv(cuda, b, h, lq, lk, seed=9)
    bias = torch.zeros((b, 1, lq, lk), device=cuda)
    bias[:, :, 70] = float("-inf")
    bias[1, :, 199] = float("-inf")
    o, lse = flash_forward(q, k, v, bias)
    gen = torch.Generator(device=cuda).manual_seed(4)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = flash_backward(q, k, v, o, lse, do, bias)
    torch.cuda.synchronize()
    assert got[0][:, :, 70].abs().max().item() == 0.0
    assert got[0][1, :, 199].abs().max().item() == 0.0
    _grads_close(got, flash_backward_reference(q, k, v, o, lse, do, bias))
    # the masked rows' dO does not reach dK or dV
    do2 = do.clone()
    do2[:, :, 70] = 0
    do2[1, :, 199] = 0
    for g, g2 in zip(got[1:], flash_backward(q, k, v, o, lse, do2,
                                             bias)[1:]):
        assert torch.equal(g, g2)


def test_k6_launchers_raise_on_what_they_cannot_take(cuda):
    """The K6 launchers take bf16 (B, H, L, 64) tensors on the GPU with a
    contiguous f32 (B, H, Lq) LSE and D; anything else raises, nothing
    falls back."""
    from sasvqa_torch.ops.flash_attention import _launch_dkv, _launch_dq
    q, k, v = _split_head_qkv(cuda, 1, 2, 130, 200, seed=1)
    lse = torch.zeros((1, 2, 130), device=cuda)
    o = do = q
    with pytest.raises(ValueError, match="bf16"):
        _launch_dq(q.float(), k, v, o, lse, do, None)
    q32 = torch.zeros((1, 2, 130, 32), device=cuda, dtype=torch.bfloat16)
    k32 = torch.zeros((1, 2, 200, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh=64"):
        _launch_dq(q32, k32, k32, q32, lse, q32, None)
    with pytest.raises(ValueError, match="LSE"):
        strided = torch.zeros((1, 2, 130, 2), device=cuda)[..., 0]
        _launch_dq(q, k, v, o, strided, do, None)
    with pytest.raises(ValueError, match="GPU"):
        _launch_dq(q.cpu(), k, v, o, lse, do, None)
    with pytest.raises(ValueError, match="does not broadcast"):
        _launch_dq(q, k, v, o, lse, do, torch.zeros((1, 1, 7, 200),
                                                     device=cuda))
    _, delta = _launch_dq(q, k, v, o, lse, do, None)
    with pytest.raises(ValueError, match="Lq\\) D"):
        _launch_dkv(q, k, v, o, lse, do, None, delta[..., :64])


# ---- K2: the fused git-flash backward on the Hopper mainloop ---------------

# (B, H, num_img, L, rate): ragged S, num_img on both sides of a 64 and a
# 128 boundary (the key halves and the 128-key tiles), a text-heavy
# sequence, and one key
TILING_FUSED_SHAPES = [
    (2, 2, 63, 2, 0.0), (1, 2, 64, 5, 0.1), (2, 2, 65, 70, 0.0),
    (1, 3, 127, 2, 0.1), (2, 2, 128, 5, 0.0), (1, 2, 129, 70, 0.1),
    (2, 2, 255, 3, 0.0), (1, 2, 256, 1, 0.1), (2, 2, 1, 200, 0.1),
    (2, 2, 564, 13, 0.0), (1, 2, 640, 64, 0.1), (1, 1, 1, 1, 0.0)]


def _fused_args(cuda, b, h, num_img, l, rate):
    from sasvqa_torch.ops import git_flash as gf
    _, q, k, v = _qkv(cuda, b, h, num_img, l, seed=5 * num_img + l)
    mask = _mask(b, l, num_img + 13).to(cuda)
    seed = torch.tensor([-(2 ** 31) + 7 * num_img], dtype=torch.int32,
                        device=cuda)
    o, lse = git_flash_attention(q, k, v, mask, num_img, rate, seed)
    gen = torch.Generator(device=cuda).manual_seed(l + 2)
    do = split_heads(torch.randn((b, num_img + l, h * 64), generator=gen,
                                 device=cuda).to(torch.bfloat16), h)
    return gf, (q, k, v, o, lse, do, mask, num_img, rate, seed)


@pytest.mark.parametrize("b,h,num_img,l,rate", TILING_FUSED_SHAPES)
def test_k2_tiling_edges_match_plain(cuda, b, h, num_img, l, rate):
    """K2 (wgmma/TMA, 128-key tiles, dQ by TMA reductions) on split-head
    views with S and num_img about a 64- and a 128-key boundary: within
    the chip_smoke.py tolerance of the plain fused backward, one launch
    (and one dropout-hash launch at rate > 0)."""
    gf, args = _fused_args(cuda, b, h, num_img, l, rate)
    _build.reset_launch_counts()
    got = gf._launch_bwd(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["git_flash_bwd"] == 1
    assert _build.launch_counts["hash_dropout"] == (1 if rate else 0)
    _grads_close(got, git_flash_backward_reference(*args))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k2_dkv_bits_repeat_and_dq_stays_close(cuda, rate):
    """dK and dV are the same bits on a second launch; dQ, whose f32 sums
    arrive in run-dependent order, stays within the gradient tolerance of
    the second launch."""
    gf, args = _fused_args(cuda, 2, 3, 391, 23, rate)
    first = gf._launch_bwd(*args)
    second = gf._launch_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    scale = max(first[0].float().abs().max().item(), 1e-6)
    assert (first[0].float() - second[0].float()).abs().max().item() \
        <= TOL_GRAD_REL * scale


def test_k2_reduce_only_touches_only_the_workspace(cuda):
    """The reduction-only instrument adds zero tiles: its f32 workspace
    comes back zero, and it counts no launch."""
    gf, args = _fused_args(cuda, 1, 2, 200, 9, 0.1)
    _build.reset_launch_counts()
    ws = gf._launch_bwd_reduce_only(*args)
    torch.cuda.synchronize()
    assert not any(_build.launch_counts.values())
    assert ws.dtype == torch.float32 and not ws.any()


def test_k2_launcher_raises_on_what_it_cannot_take(cuda):
    """K2's launcher takes bf16 (B, H, S, 64) tensors on the GPU with a
    contiguous f32 (B, H, S) LSE and a fitting mask; anything else
    raises, nothing falls back to K3 or the plain version."""
    gf, args = _fused_args(cuda, 1, 2, 65, 3, 0.0)
    q, k, v, o, lse, do, mask, num_img, rate, seed = args
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="bf16"):
        gf._launch_bwd(q.float(), k, v, o, lse, do, mask, num_img)
    with pytest.raises(ValueError, match="LSE"):
        gf._launch_bwd(q, k, v, o, lse.half(), do, mask, num_img)
    with pytest.raises(ValueError, match="does not fit"):
        gf._launch_bwd(q, k, v, o, lse, do, mask, num_img - 1)
    with pytest.raises(ValueError, match="GPU"):
        gf._launch_bwd(q, k, v, o, lse, do, mask.cpu(), num_img)
    q32 = torch.zeros((1, 2, 68, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh=64"):
        gf._launch_bwd(q32, q32, q32, q32, lse, q32, mask, num_img)
    assert not any(_build.launch_counts.values())
