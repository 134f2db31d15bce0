"""LayerNorm over the last axis as one hand-written kernel a pass.

:func:`layer_norm` computes ``models/layers.LayerNorm``'s formula
(statistics in f32 from the input as given, E[x^2] - E[x]^2 clipped at
0, the output rounded once to the module's dtype) with the CUDA kernels
of ``csrc/layer_norm.cu`` and is differentiable through
:class:`_LayerNormFunction`, whose backward is a kernel too.  The JAX
package has no kernel for it (XLA fuses the plain ``jnp`` formula); the
port's plain formula runs as 14 ATen kernels forward and 30 backward.

:func:`kernel_takes` is the route: a CUDA tensor that is not a DTensor,
bf16 or f32 and in the module's dtype, of a width that is a multiple of 8
and at most 1024, under f32 parameters.  Anything else, CPU tensors
included, stays on ``LayerNorm``'s plain formula, which is the oracle the
tests hold the kernels against.

The forward saves the input and two f32 vectors of length N: the mean and
``rstd`` = rsqrt(var + eps), negated on a row whose variance the clamp
raised to 0 (autograd of the plain formula passes no gradient through the
variance there).  :func:`reference_backward` is the backward the kernel
computes, in PyTorch, and :func:`kernel_order_sums` the order in which it
sums the parameters' gradients (per-block partials, then a fixed-order
pass over columns, no atomics).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from sasvqa_torch.ops import _build

KERNEL = "layer_norm"
COUNT_FWD, COUNT_BWD = "layer_norm_fwd", "layer_norm_bwd"
# the kernels' layout (csrc/layer_norm.cu): rows a block (one warp a row),
# elements a chunk, the column pass's row groups, the widest row
WARPS, VEC, COL_GROUPS, MAX_WIDTH = 8, 8, 32, 1024
DTYPES = (torch.bfloat16, torch.float32)

_fns: Dict[str, object] = {}
_max_blocks: Dict[tuple, int] = {}


# ---- the route -------------------------------------------------------------

def takes_width_and_dtypes(width: int, x_dtype: torch.dtype,
                           out_dtype: torch.dtype,
                           param_dtype: torch.dtype) -> bool:
    """Whether the kernels take rows of ``width`` in ``x_dtype`` into
    ``out_dtype`` under ``param_dtype`` weights: one type in and out (every
    model's LayerNorms see their own dtype)."""
    return (0 < width <= MAX_WIDTH and width % VEC == 0
            and x_dtype in DTYPES and out_dtype == x_dtype
            and param_dtype == torch.float32)


def kernel_takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype) -> bool:
    """The route of ``LayerNorm.forward``: the kernels for CUDA tensors
    they take (:func:`takes_width_and_dtypes`), on one device, none a
    DTensor; the plain formula for everything else."""
    return (x.is_cuda and x.numel() > 0 and weight.device == x.device
            and bias.device == x.device and bias.dtype == weight.dtype
            and weight.shape == bias.shape == (x.shape[-1],)
            and takes_width_and_dtypes(x.shape[-1], x.dtype, dtype,
                                       weight.dtype)
            and not _build.any_dtensor(x, weight, bias))


# ---- plain versions of the kernels' arithmetic -----------------------------

def reference_stats(x: torch.Tensor, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, signed rstd) of (N, D) rows as the plain formula computes
    them: the saved vectors of the forward."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    raw_var = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(torch.clamp(raw_var, min=0.0) + eps)
    return mean, torch.where(raw_var < 0, -rstd, rstd)


def reference_backward(x: torch.Tensor, weight: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's formula on (N, D) rows: with g = dy * w and
    xhat = (x - mean) * |rstd|, dx = |rstd| * (g - mean(g) - xhat *
    mean(g * xhat)) (the last term dropped where ``rstd`` < 0) in x's
    dtype, dw = sum(dy * xhat) and db = sum(dy) over rows in f32."""
    r = rstd.abs()[:, None]
    xhat = (x.float() - mean[:, None]) * r
    dyf = dy.float()
    g = dyf * weight.float()
    mg = g.mean(dim=-1, keepdim=True)
    mgx = torch.where(rstd[:, None] > 0,
                      (g * xhat).mean(dim=-1, keepdim=True),
                      torch.zeros_like(mg))
    dx = r * (g - mg - xhat * mgx)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def kernel_order_sums(dy: torch.Tensor, xhat: torch.Tensor, grid: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) = the column sums of dy * xhat and dy over (N, D) f32 rows
    in the backward kernel's order at ``grid`` blocks: row r goes to warp
    r mod (grid * WARPS) (block (r mod (grid * WARPS)) // WARPS), each
    warp adds its rows in order, each block its warps in order into a
    partial row, and the column pass adds partial rows g = t, t + 32, ...
    for each t < 32, then those 32 sums in order.  Every step is one
    rounded f32 op, as in the kernel, so on the card the two agree bit for
    bit."""
    n, d = dy.shape
    step = grid * WARPS
    k = max(1, math.ceil(n / step))
    pad = k * step - n
    sums = []
    for term in (dy * xhat, dy):
        rows = torch.cat([term, term.new_zeros(pad, d)]).view(k, grid,
                                                              WARPS, d)
        warp = torch.zeros_like(rows[0])
        for i in range(k):
            warp = warp + rows[i]
        block = torch.zeros_like(warp[:, 0])
        for w in range(WARPS):
            block = block + warp[:, w]
        groups = math.ceil(grid / COL_GROUPS)
        parts = torch.cat([block, block.new_zeros(
            groups * COL_GROUPS - grid, d)]).view(groups, COL_GROUPS, d)
        col = torch.zeros_like(parts[0])
        for i in range(groups):
            col = col + parts[i]
        total = torch.zeros_like(col[0])
        for t in range(COL_GROUPS):
            total = total + col[t]
        sums.append(total)
    return sums[0], sums[1]


# ---- the CUDA kernels ------------------------------------------------------

def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(KERNEL), name)
        if name == "layer_norm_max_blocks":
            fn.argtypes = [ctypes.c_int] * 3
        elif name == "layer_norm_fwd":
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                           + [ctypes.c_float] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def grid_for(backward: bool, n: int, width: int, f32: bool,
             device: torch.device) -> int:
    """The persistent grid: the blocks the card holds at once (asked of
    the CUDA occupancy calculator once per kind), no more than the rows
    need."""
    key = (backward, width, f32, device.index)
    blocks = _max_blocks.get(key)
    if blocks is None:
        with torch.cuda.device(device):
            blocks = _kernel_fn("layer_norm_max_blocks")(
                int(backward), int(f32), width)
        if blocks < 1:
            _build.raise_on_error(KERNEL, -blocks)
        _max_blocks[key] = blocks
    return max(1, min(blocks, math.ceil(n / WARPS)))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, D) contiguous rows on a 16-byte boundary."""
    t = t.reshape(-1, t.shape[-1])
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def forward_kernel(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float, save: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(y in ``x``'s shape and dtype, x as (N, D) rows, mean, signed
    rstd): one launch; the statistics only when ``save``."""
    rows = _rows(x)
    n, d = rows.shape
    y = torch.empty_like(rows)
    mean = rstd = None
    if save:
        mean = torch.empty(n, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    f32 = rows.dtype == torch.float32
    grid = grid_for(False, n, d, f32, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn("layer_norm_fwd")(
            rows.data_ptr(), weight.contiguous().data_ptr(),
            bias.contiguous().data_ptr(), y.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if rstd is None else rstd.data_ptr(), n, d, eps, int(f32),
            grid, stream)
    _build.raise_on_error(KERNEL, err)
    _build.count_launch(COUNT_FWD)
    return y.view(x.shape), rows, mean, rstd


def backward_kernel(rows: torch.Tensor, weight: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor,
                    dy: torch.Tensor, params: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """(dx as (N, D) rows in x's dtype, dw, db) from the forward's rows
    and statistics: the row kernel and, when ``params``, the column pass
    that sums its per-block partials (dw and db None otherwise)."""
    dy = _rows(dy)
    n, d = rows.shape
    dx = torch.empty_like(rows)
    f32 = rows.dtype == torch.float32
    grid = grid_for(True, n, d, f32, rows.device)
    part = dwdb = None
    if params:
        part = torch.empty((2, grid, d), dtype=torch.float32,
                           device=rows.device)
        dwdb = torch.empty((2, d), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        err = _kernel_fn("layer_norm_bwd")(
            rows.data_ptr(), dy.data_ptr(), weight.contiguous().data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dwdb is None else dwdb.data_ptr(), n, d, int(f32), grid,
            stream)
    _build.raise_on_error(KERNEL, err)
    _build.count_launch(COUNT_BWD)
    if dwdb is None:
        return dx, None, None
    return dx, dwdb[0], dwdb[1]


class _LayerNormFunction(torch.autograd.Function):
    """The kernels under autograd: the forward saves the (N, D) input
    rows, the weight and the two (N) f32 statistics; the backward is the
    backward kernel (and its column pass when a parameter needs its
    gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, rows, mean, rstd = forward_kernel(x, weight, bias, eps, save=True)
        ctx.save_for_backward(rows, weight, mean, rstd)
        ctx.x_shape = x.shape
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        rows, weight, mean, rstd = ctx.saved_tensors
        params = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dw, db = backward_kernel(rows, weight, mean, rstd, dy, params)
        return (dx.view(ctx.x_shape),
                dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``LayerNorm``'s formula over the last axis of ``x``, in x's dtype,
    by the kernels (the caller has checked :func:`kernel_takes`);
    differentiable in x, weight and bias, and saving nothing where no
    gradient is wanted."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNormFunction.apply(x, weight, bias, eps)
    return forward_kernel(x, weight, bias, eps, save=False)[0]
