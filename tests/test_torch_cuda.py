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


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


# K2's eager runs in the replay test: the graph's largest gap to them
# against their largest gap to each other.  On an H100 (9 repetitions of
# the graph against 6 eager runs, 6 with LayerNorm's plain formula and 3
# with its kernels) the ratio read at most 1.42 of the 2 allowed; of the
# subsets of 3 eager runs 4 in 180 exceeded 2, of 4 or more none.  Two K2
# runs lay 0 to 0.0027 apart in update 0 and 0 to 0.024 in update 1; so
# that eager runs that all repeat one order still measure some noise, the
# spread counts as at least one bf16 step (2^-8 of a leaf's largest
# magnitude).
K2_EAGER_RUNS = 6
K2_ORDER_FLOOR = 2.0 ** -8


@pytest.mark.parametrize("flash", [False, True])
def test_replayed_micros_equal_the_eager_path(cuda, flash, monkeypatch):
    """Two updates of 4 micros of a tiny GIT with its dropouts on, through
    the train step's captured graph (3 eager warm-up micros, the capture,
    5 replays) and through the eager path on a copy: the same per-micro
    losses, gradients (each parameter's ``.grad`` after the update), AdamW
    moments and launch counts (one LayerNorm forward and one backward
    launch a LayerNorm call of a micro), bit for bit, on the dense route
    and on the git-flash route with the split backward (K3, no atomics).
    The fused backward (K2) sums dQ by TMA reductions in no fixed order,
    so the eager path is run several times to measure how far it differs
    from itself; in both updates the graph's losses and gradients lie as
    close to each eager run as the eager runs lie to each other (within
    twice their largest gap, and at least twice one bf16 step in case
    every eager run repeats one order), where the wrong dropout draw or
    accumulation would be off by the gradient's size."""
    from sasvqa_torch.ops import git_flash as gf
    from sasvqa_torch.train import steps
    cfg, cls = _dh64_git()
    cfg = dataclasses.replace(cfg, attention_dropout=0.1)
    rng = np.random.default_rng(3)
    k = 4

    def micro():
        return {"text_input_ids": torch.from_numpy(
                    rng.integers(5, 500, (2, 12))).to(cuda),
                "text_attention_mask": torch.ones((2, 12), dtype=torch.int32,
                                                  device=cuda),
                "visual_inputs": torch.from_numpy(rng.normal(
                    size=(2, 8, 64, 64, 3)).astype(np.float32)).to(
                        cuda).bfloat16(),
                "labels": torch.from_numpy(
                    rng.integers(5, 500, (2, 12))).to(cuda)}

    micros = [micro() for _ in range(2 * k)]

    def run(graph, fused):
        from sasvqa_torch.models.layers import LayerNorm
        monkeypatch.setattr(gf, "FUSED_BWD", fused)
        model = cls(cfg, dtype=torch.bfloat16, flash=flash,
                    generator=torch.Generator().manual_seed(0))
        ln_calls = [0]
        for mod in model.modules():
            if isinstance(mod, LayerNorm):
                mod.register_forward_pre_hook(
                    lambda *_: ln_calls.__setitem__(0, ln_calls[0] + 1))
        state = steps.create_train_state(model, {"learning_rate": 1e-3,
                                                 "grad_norm": 5.0}, 10)
        _build.reset_launch_counts()
        steps.reset_micro_counts()
        losses, grads = [], []
        for u in range(2):
            acc, ls, _, on_graph = steps._accumulate(
                state, micros[u * k:(u + 1) * k], 7, True, cuda,
                steps._git_loss, graph)
            assert on_graph == (graph is not None)
            for p, a in zip(state.optimizer.params, acc):
                p.grad = a
            state.optimizer.update(acc)
            state.step += k
            losses.append(torch.stack(ls))
            grads.append([p.grad.clone() for p in state.optimizer.params])
        torch.cuda.synchronize()
        return dict(losses=losses, grads=grads,
                    launches=dict(_build.launch_counts),
                    replayed=dict(_build.replayed_counts),
                    micros=dict(steps.micro_counts), ln_calls=ln_calls[0],
                    moments=state.optimizer.mu + state.optimizer.nu)

    def graph_and_eager(fused, n_eager=1):
        graphed = run(steps.MicroGraph(steps._git_loss, True), fused)
        eager = [run(None, fused) for _ in range(n_eager)]
        assert eager[0]["micros"] == {"replayed": 0, "eager": 2 * k}
        assert graphed["micros"] == {"replayed": 5, "eager": 3}
        assert graphed["launches"] == eager[0]["launches"]
        per_micro = {n: c // (2 * k) for n, c in eager[0]["launches"].items()}
        assert graphed["replayed"] == {n: 5 * c for n, c in per_micro.items()}
        layers = cfg.num_layers if flash else 0
        assert per_micro["git_flash_bwd"] == (layers if fused else 0)
        assert per_micro["git_flash_bwd_dq"] == (0 if fused else layers)
        # every LayerNorm call of a micro is one forward and one backward
        # launch, captured or replayed alike
        assert per_micro["layer_norm_fwd"] == per_micro["layer_norm_bwd"] \
            == eager[0]["ln_calls"] // (2 * k) > 0
        return graphed, eager

    graphed, (eager,) = graph_and_eager(fused=not flash)
    for u in range(2):
        assert torch.equal(_bits(graphed["losses"][u]),
                           _bits(eager["losses"][u])), u
        for a, b in zip(graphed["grads"][u], eager["grads"][u]):
            assert torch.equal(_bits(a), _bits(b)), u
    for a, b in zip(graphed["moments"], eager["moments"]):
        assert torch.equal(_bits(a), _bits(b))
    if not flash:
        return

    def gap(x, y, u):
        """The largest difference of two runs in update ``u``: of a loss
        relative to the losses' largest magnitude, or of a gradient
        relative to its leaf's."""
        worst = ((x["losses"][u] - y["losses"][u]).abs().max()
                 / y["losses"][u].abs().max()).item()
        for a, b in zip(x["grads"][u], y["grads"][u]):
            worst = max(worst, ((a - b).abs().max()
                                / b.abs().max().clamp(min=1e-12)).item())
        return worst

    k2_graphed, k2_eager = graph_and_eager(fused=True,
                                           n_eager=K2_EAGER_RUNS)
    for u in range(2):
        spread = max(gap(k2_eager[i], k2_eager[j], u)
                     for i in range(K2_EAGER_RUNS)
                     for j in range(i + 1, K2_EAGER_RUNS))
        off = max(gap(k2_graphed, e, u) for e in k2_eager)
        assert off <= 2 * max(spread, K2_ORDER_FLOOR), (u, off, spread)


def test_welford_factor_rounds_as_the_host_scalar_division(cuda):
    """On the card, ``d / (i + 1)`` by the host scalar (the eager
    accumulation the graph replaced) is ``d * _welford_factor(i)`` bit for
    bit, whether the factor is a host float or a device scalar."""
    from sasvqa_torch.train.steps import _welford_factor
    gen = torch.Generator(device=cuda).manual_seed(0)
    d = torch.randn(1 << 16, device=cuda, generator=gen) * 1e-3
    for i in range(1, 80):
        want = d / (i + 1)
        f = _welford_factor(i)
        assert torch.equal(_bits(want), _bits(d.clone().mul_(f))), i
        dev_f = torch.full((), f, dtype=torch.float32, device=cuda)
        assert torch.equal(_bits(want), _bits(d.clone().mul_(dev_f))), i


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


# ---- the classifier loop's step on loaded weights -------------------------


def _classifier_step_on_loaded_weights(model, family, shapes, tmp_path,
                                       img, frames=2):
    """Write a seeded checkpoint in HF's names (``tools.hf_checkpoint``'s
    generator), load it, check the loaded leaves against it, then run one
    2-micro adam update of the loop's classifier step; returns the loss
    and the launch counts of that update."""
    from sasvqa_torch.models import convert as cv
    from sasvqa_torch.models.presets import load_pretrained_params
    from sasvqa_torch.tools import hf_checkpoint as hfc
    from sasvqa_torch.train.steps import (create_train_state,
                                          make_scan_train_step)
    path, sd, _ = hfc.write_hf_checkpoint(str(tmp_path), shapes, 0)
    report = load_pretrained_params(family, model, path)
    assert not report["mismatched"]
    assert report["missing_in_ckpt"] == ["/answer_head"]
    tc, vc = model.text_config, model.vision_config
    if family == "clip":
        converted = cv.convert_clip_video_qa(sd, tc.num_layers,
                                             vc.num_layers)
    else:
        converted = {
            "txt_model": cv.convert_blip_text(sd, tc.num_layers,
                                              prefix="text_model"),
            "vis_model": cv.convert_blip_vision(sd, vc.num_layers,
                                                prefix="vision_model")}
    compared, differ = hfc.check_loaded(model, converted)
    assert compared == len(report["loaded"]) and not differ, differ
    assert compared == sum(not n.startswith("answer_head.")
                           for n, _ in model.named_parameters())
    rng = np.random.default_rng(0)
    b, l, k = 4, 12, 2
    batch = {"text_input_ids": rng.integers(3, 500, size=(k, b, l)),
             "text_attention_mask": np.ones((k, b, l), np.int32),
             "visual_inputs": rng.standard_normal(
                 (k, b, frames, img, img, 3), dtype=np.float32),
             "labels": rng.integers(0, 5, size=(k, b))}
    state = create_train_state(model, {"optim": "adam",
                                       "learning_rate": 1e-4,
                                       "decay": "constant"}, 4, device="cuda")
    _build.reset_launch_counts()
    state, metrics = make_scan_train_step(k, "classifier", device="cuda")(
        state, batch, 0)
    torch.cuda.synchronize()
    return metrics["loss"].item(), dict(_build.launch_counts)


def test_clip_loop_step_on_loaded_weights(cuda, tmp_path):
    """tiny-clip in bf16: the loader puts every encoder leaf of a
    checkpoint in HF CLIPModel names in place, and a classifier update
    gives a finite loss (the 197-token-or-shorter CLIP path runs no
    attention kernel; its LayerNorms run theirs)."""
    from sasvqa_torch.tools import hf_checkpoint as hfc
    from sasvqa_torch.models.presets import build_model
    _, model = build_model({"model": {"pretrained_model": "tiny-clip"},
                            "img_size": 32, "num_labels": 5,
                            "classifier": "mlp"}, dtype=torch.bfloat16,
                           device=cuda)
    loss, launches = _classifier_step_on_loaded_weights(
        model, "clip", hfc.hf_clip_shapes(model.text_config,
                                                 model.vision_config),
        tmp_path, img=32)
    assert np.isfinite(loss)
    assert not any(n for k, n in launches.items()
                   if not k.startswith("layer_norm")), launches
    assert launches["layer_norm_fwd"] == launches["layer_norm_bwd"] > 0


def test_blip_loop_step_on_loaded_weights_runs_k5_k6(cuda, tmp_path):
    """A 2-layer BLIP with 64-wide heads at 384x384 (577 tokens a frame)
    in bf16: the loader puts every encoder leaf of a checkpoint in HF
    BlipModel names in place, and a classifier update gives a finite loss
    through K5 and K6 in the vision tower."""
    from sasvqa_torch.tools import hf_checkpoint as hfc
    from sasvqa_torch.models.blip import BLIPTextConfig, BLIPVisionConfig
    from sasvqa_torch.models.video_qa import (BLIPVideoQA,
                                              ClassifierHeadConfig)
    tc = BLIPTextConfig(vocab_size=512, hidden_size=128,
                        intermediate_size=256, num_layers=2, num_heads=2,
                        max_position_embeddings=64, encoder_width=128)
    vc = BLIPVisionConfig(hidden_size=128, intermediate_size=256,
                          num_layers=2, num_heads=2)
    model = BLIPVideoQA(tc, vc, ClassifierHeadConfig(num_labels=5),
                        dtype=torch.bfloat16).to(cuda)
    loss, launches = _classifier_step_on_loaded_weights(
        model, "blip", hfc.hf_blip_shapes(tc, vc), tmp_path,
        img=vc.image_size, frames=1)
    assert np.isfinite(loss)
    # 2 micros x 2 vision layers
    assert launches["flash_fwd"] == 4, launches
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 4


@pytest.mark.parametrize("n,w,bucket", [(300, 8, 512), (1500, 8, 2048),
                                        (20, 4, 64)])
def test_mdf_selection_on_the_card_equals_cpu(cuda, n, w, bucket):
    """MDF selection on CUDA tensors picks what it picks on the CPU from
    the same padded features, the exhausted fallback included, reading
    nothing back inside its loop."""
    from sasvqa_torch.sampling.mdf import (mdf_reference_numpy,
                                           mdf_select_padded)
    feats = np.random.default_rng(n).normal(size=(n, 768)).astype(
        np.float32)
    padded = np.zeros((bucket, 768), np.float32)
    padded[:n] = feats
    got, got_ex = mdf_select_padded(torch.from_numpy(padded).to(cuda), n,
                                    16, w)
    want, want_ex = mdf_select_padded(torch.from_numpy(padded), n, 16, w)
    assert got.device.type == "cuda"
    assert got.cpu().tolist() == want.tolist()
    assert bool(got_ex) == bool(want_ex) == (n == 20)
    assert got.cpu().tolist() == mdf_reference_numpy(feats, 16, w).tolist()


# ---- the LayerNorm kernels -------------------------------------------------

# (rows, width): the BLIP-large vision stream of a micro (32 frames x 577
# tokens), the GIT shape, row counts that are no multiple of any grid (at
# the narrowest width and the widest the kernels take), and BERT's width
LN_SHAPES = [(18464, 1024), (7284, 768), (2113, 512), (301, 1024), (37, 768)]
LN_EPS = 1e-6


def _ln_case(cuda, n, d, dtype, seed):
    from sasvqa_torch.models.layers import LayerNorm
    gen = torch.Generator(device=cuda).manual_seed(seed)
    m = LayerNorm(d, LN_EPS, dtype).to(cuda)
    with torch.no_grad():
        m.weight.copy_(1 + 0.5 * torch.randn(d, device=cuda, generator=gen))
        m.bias.copy_(0.5 * torch.randn(d, device=cuda, generator=gen))
    x = (0.3 + torch.randn(n, d, device=cuda, generator=gen)).to(dtype)
    dy = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    return m, x, dy


def _ln_grads(m, x, dy, plain):
    x = x.detach().requires_grad_(True)      # keeps x's strides
    m.zero_grad(set_to_none=True)
    y = m.plain(x) if plain else m(x)
    y.backward(dy)
    torch.cuda.synchronize()
    return y.detach(), x.grad, m.weight.grad, m.bias.grad


def _ulps_bf16(a, b):
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _close_bf16(got, want):
    """Within 1 bf16 step, or, where a value is so small that the f32
    orders' own noise (1e-6 of the largest magnitude) spans more than a
    step, within that."""
    floor = 1e-6 * want.float().abs().max()
    return bool(((_ulps_bf16(got, want) <= 1)
                 | ((got.float() - want.float()).abs() <= floor)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d", LN_SHAPES)
def test_layer_norm_kernels_match_the_plain_formula(cuda, n, d, dtype):
    """Kernel route against ``LayerNorm.plain`` on the same inputs.  The
    two differ only in the order of the f32 row sums (mean, E[x^2],
    sum(g), sum(g xhat)) and of the column sums (dw, db), so: y and dx
    within 1 bf16 step (bf16; or, near 0, within 1e-6 of the largest
    magnitude) or 1e-5 of their largest magnitude (f32);
    dw and db within 2^-16 of each column's sum of |terms|, the error
    bound of an f32 sum 256 adds deep, which holds both orders."""
    m, x, dy = _ln_case(cuda, n, d, dtype, seed=n)
    _build.reset_launch_counts()
    y, dx, dw, db = _ln_grads(m, x, dy, plain=False)
    assert _build.launch_counts["layer_norm_fwd"] == 1
    assert _build.launch_counts["layer_norm_bwd"] == 1
    py, pdx, pdw, pdb = _ln_grads(m, x, dy, plain=True)
    assert _build.launch_counts["layer_norm_fwd"] == 1
    assert y.dtype == py.dtype == dtype and dx.dtype == dtype
    if dtype == torch.bfloat16:
        assert _close_bf16(y, py) and _close_bf16(dx, pdx)
    else:
        for got, want in ((y, py), (dx, pdx)):
            assert ((got - want).abs().max()
                    / want.abs().max()).item() <= 1e-5
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(torch.clamp(
        (xf * xf).mean(-1, keepdim=True) - mean * mean, min=0) + LN_EPS)
    dyf = dy.float()
    for got, want, terms in ((dw, pdw, dyf * xhat), (db, pdb, dyf)):
        bound = 2.0 ** -16 * terms.abs().sum(dim=0)
        assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernels_repeat_their_bits(cuda, dtype):
    """Two runs give the same bits, and dw/db are the kernel's
    fixed-order sums (``kernel_order_sums``) of dy * xhat and dy, with
    xhat from the saved statistics, bit for bit."""
    from sasvqa_torch.ops import layer_norm as ln
    n, d = 18464, 1024
    m, x, dy = _ln_case(cuda, n, d, dtype, seed=5)
    runs = []
    for _ in range(2):
        y, rows, mean, rstd = ln.forward_kernel(x, m.weight, m.bias, LN_EPS,
                                                save=True)
        dx, dw, db = ln.backward_kernel(rows, m.weight, mean, rstd, dy,
                                        True)
        torch.cuda.synchronize()
        runs.append((y, mean, rstd, dx, dw, db))
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))
    _, mean, rstd, _, dw, db = runs[0]
    xhat = (x.float() - mean[:, None]) * rstd.abs()[:, None]
    grid = ln.grid_for(True, n, d, dtype == torch.float32, x.device)
    want_dw, want_db = ln.kernel_order_sums(dy.float(), xhat, grid)
    assert torch.equal(_bits(dw), _bits(want_dw))
    assert torch.equal(_bits(db), _bits(want_db))


def test_layer_norm_route_on_the_card(cuda):
    """A strided input (BLIP's CLS slice) is copied to rows and matches
    the plain formula; under no_grad the forward saves nothing and no
    backward exists; the clamp's rows (a constant f32 row) get autograd's
    dx; a width the kernels do not take (not a multiple of 8, or wider
    than 1024), or an input in another dtype than the module's, stays
    plain."""
    from sasvqa_torch.models.layers import LayerNorm
    m, x, dy = _ln_case(cuda, 4 * 577, 1024, torch.bfloat16, seed=1)
    xs = x.view(4, 577, 1024)[:, 0]
    assert not xs.is_contiguous()
    _build.reset_launch_counts()
    y, dx, dw, _ = _ln_grads(m, xs, dy[:4], plain=False)
    py, pdx, pdw, _ = _ln_grads(m, xs, dy[:4], plain=True)
    assert _build.launch_counts["layer_norm_fwd"] == 1
    assert _close_bf16(y, py) and _close_bf16(dx, pdx)
    assert dx.shape == xs.shape
    with torch.no_grad():
        y = m(x)
    assert y.grad_fn is None and _build.launch_counts["layer_norm_fwd"] == 2
    m32, x32, dy32 = _ln_case(cuda, 6, 512, torch.float32, seed=2)
    x32[3] = 0.1
    _, dx, _, _ = _ln_grads(m32, x32, dy32, plain=False)
    _, pdx, _, _ = _ln_grads(m32, x32, dy32, plain=True)
    assert ((dx - pdx).abs().max() / pdx.abs().max()).item() <= 1e-5
    odd = LayerNorm(12, LN_EPS, torch.bfloat16).to(cuda)
    wide = LayerNorm(2048, LN_EPS, torch.bfloat16).to(cuda)
    mixed = LayerNorm(768, LN_EPS, torch.float32).to(cuda)
    _build.reset_launch_counts()
    odd(torch.randn(3, 12, device=cuda, dtype=torch.bfloat16))
    wide(torch.randn(3, 2048, device=cuda, dtype=torch.bfloat16))
    mixed(torch.randn(3, 768, device=cuda, dtype=torch.bfloat16))
    assert not any(_build.launch_counts.values())
