"""The LayerNorm kernels' route and arithmetic on the CPU.

The kernels themselves (``sasvqa_torch/ops/csrc/layer_norm.cu``) run only
on the card (``tests/test_torch_cuda.py``).  Here: which tensors the route
sends to them (CPU tensors, DTensors and widths they do not take stay on
the plain formula, and no launch counter moves), the backward formula
they compute (``layer_norm.reference_backward``) against autograd of the
plain ``LayerNorm``, and the order in which they sum the parameters'
gradients (``layer_norm.kernel_order_sums``) against the full sums.
"""

import math

import pytest
import torch

from sasvqa_torch.models.layers import LayerNorm
from sasvqa_torch.ops import _build
from sasvqa_torch.ops import layer_norm as ln

WIDTHS = (512, 768, 1024)
EPS = 1e-5
F32_REL = 1e-6


def _module(width, dtype, seed):
    """A LayerNorm of ``width`` with random (not 1/0) parameters."""
    gen = torch.Generator().manual_seed(seed)
    m = LayerNorm(width, EPS, dtype)
    with torch.no_grad():
        m.weight.copy_(1 + 0.5 * torch.randn(width, generator=gen))
        m.bias.copy_(0.5 * torch.randn(width, generator=gen))
    return m


def _rows(n, width, dtype, kind, seed):
    """(n, width) rows: random ones, or random ones with a constant row
    in the middle (``constant``)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, width, generator=gen)
    if kind == "constant":
        # in f32, 0.1 * 0.1 summed over the row lies below the squared
        # mean, so the clamp engages; a bf16 row's sums are exact, so its
        # variance is exactly 0, where the clamp still passes the gradient
        x[n // 2] = 0.1
    return x.to(dtype)


# ---- the route -------------------------------------------------------------

@pytest.mark.parametrize("width,x_dtype,out_dtype,param_dtype,takes", [
    (512, torch.bfloat16, torch.bfloat16, torch.float32, True),
    (768, torch.bfloat16, torch.bfloat16, torch.float32, True),
    (1024, torch.float32, torch.float32, torch.float32, True),
    (8, torch.bfloat16, torch.bfloat16, torch.float32, True),
    (1024, torch.bfloat16, torch.float32, torch.float32, False),
    (1024, torch.float32, torch.bfloat16, torch.float32, False),
    (12, torch.bfloat16, torch.bfloat16, torch.float32, False),
    (1032, torch.bfloat16, torch.bfloat16, torch.float32, False),
    (4096, torch.float32, torch.float32, torch.float32, False),
    (8192, torch.bfloat16, torch.bfloat16, torch.float32, False),
    (0, torch.bfloat16, torch.bfloat16, torch.float32, False),
    (768, torch.float16, torch.bfloat16, torch.float32, False),
    (768, torch.bfloat16, torch.float16, torch.float32, False),
    (768, torch.bfloat16, torch.bfloat16, torch.bfloat16, False),
])
def test_kernels_take_only_their_widths_and_dtypes(width, x_dtype,
                                                   out_dtype, param_dtype,
                                                   takes):
    assert ln.takes_width_and_dtypes(width, x_dtype, out_dtype,
                                     param_dtype) is takes


@pytest.mark.parametrize("width", WIDTHS + (12,))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_stay_on_the_plain_formula(width, dtype):
    """On the CPU ``LayerNorm`` runs its plain formula, forward and
    backward, and no kernel counter moves."""
    m = _module(width, dtype, seed=width)
    x = _rows(5, width, dtype, "random", seed=1).requires_grad_(True)
    assert not ln.kernel_takes(x, m.weight, m.bias, dtype)
    _build.reset_launch_counts()
    y = m(x)
    y.float().square().sum().backward()
    assert not any(_build.launch_counts.values())
    xf = x.detach().float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0)
    want = ((xf - mean) * (torch.rsqrt(var + EPS) * m.weight)
            + m.bias).to(dtype)
    assert y.dtype == dtype and torch.equal(y, want)
    assert x.grad is not None and m.weight.grad is not None


def test_dtensors_stay_on_the_plain_formula(tmp_path):
    """A DTensor input or parameter is never routed to the kernels (they
    take a rank's plain local tensors)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (dist.get_world_size(),))
        m = _module(64, torch.float32, seed=0)
        x = torch.randn(3, 64)
        dx = distribute_tensor(x, mesh, [Replicate()])
        dw = distribute_tensor(m.weight.detach(), mesh, [Replicate()])
        assert not _build.any_dtensor(x, m.weight, m.bias)
        assert _build.any_dtensor(dx, m.weight, m.bias)
        assert _build.any_dtensor(x, dw, m.bias)
        assert not ln.kernel_takes(dx, m.weight, m.bias, torch.float32)
    finally:
        if own:
            dist.destroy_process_group()


# ---- the backward formula --------------------------------------------------

def _ulps_bf16(a, b):
    """Distance in bf16 steps between two bf16 tensors of any signs."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _close_bf16(got, want):
    """Within 1 bf16 step of each other, or, where the values are so
    small that the f32 results' own 1e-6 (relative to the largest) spans
    more than a step, within that."""
    floor = F32_REL * want.float().abs().max()
    return bool(((_ulps_bf16(got, want) <= 1)
                 | ((got.float() - want.float()).abs() <= floor)).all())


def _close_f32(got, want):
    scale = want.abs().max().clamp(min=1e-30)
    return ((got - want).abs().max() / scale).item() <= F32_REL


@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", WIDTHS)
def test_reference_backward_equals_autograd_of_the_plain_formula(width,
                                                                  dtype,
                                                                  kind):
    """The backward the kernel computes, from the forward's saved mean
    and signed rstd, equals autograd of the plain ``LayerNorm``: within
    1e-6 of each gradient's largest magnitude in f32, within one bf16
    step after the cast of a bf16 input's gradient."""
    n = 6
    m = _module(width, dtype, seed=width + 1)
    x = _rows(n, width, dtype, kind, seed=width).requires_grad_(True)
    gen = torch.Generator().manual_seed(7)
    dy = torch.randn(n, width, generator=gen).to(dtype)
    m(x).backward(dy)
    mean, rstd = ln.reference_stats(x.detach(), EPS)
    if kind == "constant":
        # f32: the clamp engaged (rstd < 0); bf16: exactly at the clamp
        assert (rstd[n // 2] < 0).item() is (dtype == torch.float32)
        assert (rstd[:n // 2] > 0).all() and (rstd[n // 2 + 1:] > 0).all()
    dx, dw, db = ln.reference_backward(x.detach(), m.weight.detach(), mean,
                                       rstd, dy)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    if dtype == torch.float32:
        assert _close_f32(dx, x.grad)
    else:
        assert _close_bf16(dx, x.grad)
    assert _close_f32(dw, m.weight.grad)
    assert _close_f32(db, m.bias.grad)


def test_the_clamp_flag_drops_the_variance_term():
    """Rows near 1000 with a spread of 0.01: E[x^2] - E[x]^2 rounds below
    0, the clamp engages, and autograd of the plain formula passes
    nothing through the variance.  The reference drops that term by the
    sign of rstd, and the term is not 0 there (xhat is of order 1), so
    keeping it would give another dx."""
    gen = torch.Generator().manual_seed(0)
    x = (1000 + 0.01 * torch.randn(4, 512, generator=gen))[1:]
    mean, rstd = ln.reference_stats(x, EPS)
    assert (rstd < 0).all()
    m = _module(512, torch.float32, seed=3)
    dy = torch.randn(3, 512, generator=gen)
    xa = x.clone().requires_grad_(True)
    m(xa).backward(dy)
    w = m.weight.detach()
    dropped = ln.reference_backward(x, w, mean, rstd, dy)[0]
    kept = ln.reference_backward(x, w, mean, rstd.abs(), dy)[0]
    assert _close_f32(dropped, xa.grad)
    assert not _close_f32(kept, xa.grad)


# ---- the parameters' gradients in the kernel's order -----------------------

@pytest.mark.parametrize("n,width,grid", [
    (18464 // 16, 1024, 132),     # rows over every block, some twice
    (1000, 768, 264),             # fewer rows than the grid's warps
    (8 * 33 + 5, 512, 33),        # a ragged last pass, a ragged last group
    (7, 64, 1),                   # one block, one partial row
])
def test_kernel_order_sums_equal_the_full_sums(n, width, grid):
    """dw and db summed from block partials in the kernel's order equal
    the full column sums, within the bound of an f32 sum of that depth
    (the adds on a column's longest path, times 2^-24, times the sum of
    the terms' magnitudes)."""
    gen = torch.Generator().manual_seed(n)
    dy = torch.randn(n, width, generator=gen)
    xhat = torch.randn(n, width, generator=gen)
    dw, db = ln.kernel_order_sums(dy, xhat, grid)
    depth = (math.ceil(n / (grid * ln.WARPS)) + ln.WARPS
             + math.ceil(grid / ln.COL_GROUPS) + ln.COL_GROUPS)
    for got, terms in ((dw, dy * xhat), (db, dy)):
        exact = terms.double().sum(dim=0)
        bound = depth * 2.0 ** -24 * terms.double().abs().sum(dim=0)
        assert got.dtype == torch.float32 and got.shape == (width,)
        assert bool(((got.double() - exact).abs() <= bound).all())
        assert torch.allclose(got, terms.sum(dim=0), rtol=0,
                              atol=float(bound.max()) * 2)

