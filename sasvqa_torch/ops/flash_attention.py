"""Flash attention with an optional additive bias, forward and backward
(counterpart of sasvqa_tpu/ops/flash_attention.py).

:func:`flash_attention` computes softmax(q k^T * Dh^-0.5 + bias) v over
(B, H, L, Dh) tensors without building the (Lq, Lk) score matrix, and is
differentiable through :class:`_FlashFunction`:

- CUDA tensors launch the hand-written Hopper kernels
  ``csrc/flash_fwd.cu`` (replaces the Pallas TPU kernel ``_flash_core``)
  and ``csrc/flash_bwd.cu`` (replaces ``_dq_core`` and ``_dkv_core``: a dQ
  kernel and a dK/dV kernel, no atomics).  A CUDA tensor the kernels
  cannot take (not bf16, Dh != 64) raises;
- CPU tensors take :func:`flash_attention_reference` and
  :func:`flash_backward_reference`, the plain PyTorch versions of the same
  functions, which the tests hold against the JAX package and the kernels
  are held against on the card.

The bias broadcasts from (B|1, H|1, 1|Lq, Lk); the kernels read it through
its broadcast strides, so a row bias stays O(Lk).  Its cotangent, needed
only when the bias itself requires grad, is the dense plain expression.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import _plain_attention

KERNEL_FWD = "flash_fwd"
KERNEL_BWD = "flash_bwd"
COUNT_DQ, COUNT_DKV = "flash_bwd_dq", "flash_bwd_dkv"
HEAD_DIM = 64

_fns = {}


# ---- plain versions of the kernels ----------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 scores with the scale applied to q first, as the TPU forward
    does (``flash_attention.py:71``), plus the f32 bias."""
    s = torch.matmul(q.float() * q.shape[-1] ** -0.5,
                     k.float().transpose(-1, -2))
    return s if bias is None else s + bias.float()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: f32 scores and softmax
    statistics, P in f32 for P@V, O = acc / l in q's dtype (a row with
    l == 0, reachable only through an -inf bias, gives zeros) and the f32
    per-row LSE = m + log(l)."""
    s = _scores(q, k, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = (torch.matmul(p, v.float()) / safe_l).to(q.dtype)
    return out, (m + torch.log(safe_l))[..., 0]


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of the backward kernels with the TPU
    kernels' numerics (``_dq_core``, ``_dkv_core``): scores scaled after
    q k^T, P = exp(S - LSE) recomputed, D = rowsum(dO * O), dS =
    P * (dO v^T - D); dQ = dS k * scale, dK = dS^T q * scale, dV = P^T dO,
    all in f32 and cast to the input dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    # an LSE of -inf (no attendable key) gives P = 0 for its row
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, float("inf")),
                      lse)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    d_row = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) - d_row)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---- the CUDA kernels ------------------------------------------------------

def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        if name == KERNEL_FWD:
            fn = _build.load(KERNEL_FWD).flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 16
                           + [ctypes.c_float, ctypes.c_void_p])
        else:   # flash_bwd_dq / flash_bwd_dkv: the same argument layout
            fn = getattr(_build.load(KERNEL_BWD), name)
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 22
                           + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, *more):
    """The kernels' contract on q (B, H, Lq, 64), k/v (B, H, Lk, 64) and
    the (B, H, Lq, 64) tensors in ``more``, all bf16 on one GPU."""
    xs = (q, k, v) + more
    if not all(x.is_cuda for x in xs):
        raise ValueError("flash kernels need every tensor on the GPU")
    if any(x.dtype != torch.bfloat16 for x in xs):
        raise ValueError("flash kernels take bf16 tensors, got "
                         + "/".join(str(x.dtype) for x in xs))
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3] \
            or any(x.shape != q.shape for x in more):
        raise ValueError("q (B, H, Lq, Dh) and k/v (B, H, Lk, Dh) do not "
                         "fit: " + "/".join(str(tuple(x.shape)) for x in xs))
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"flash kernels take Dh={HEAD_DIM}, got "
                         f"{q.shape[3]}")


def _bias_args(bias: Optional[torch.Tensor], q: torch.Tensor,
               lk: int) -> Tuple[torch.Tensor, list]:
    """The bias as an f32 (B, H, Lq, Lk) view with stride 0 on its
    broadcast axes (no copy of the full shape), and its four strides; a
    null pointer and zeros without a bias."""
    if bias is None:
        return None, [0, 0, 0, 0]
    b, h, lq, _ = q.shape
    if bias.dim() != 4 or bias.shape[0] not in (1, b) \
            or bias.shape[1] not in (1, h) or bias.shape[2] not in (1, lq) \
            or bias.shape[3] not in (1, lk):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"(B, H, Lq, Lk) = {(b, h, lq, lk)}")
    full = bias.to(device=q.device, dtype=torch.float32).expand(b, h, lq, lk)
    return full, list(full.stride())


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch_fwd(q, k, v, bias):
    """K5 on CUDA tensors: (O in (B, Lq, H, Dh) memory order, f32 LSE)."""
    _check(q, k, v)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    q, k, v = (_build.tma_ready(x) for x in (q, k, v))
    bias_f, bias_strides = _bias_args(bias, q, lk)
    # O is written as (B, Lq, H, Dh) so that merge_heads is a free reshape
    out = torch.empty((b, lq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn(KERNEL_FWD)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_f),
            out.data_ptr(), lse.data_ptr(), b, h, lq, lk, *strides,
            *bias_strides, dh ** -0.5, stream)
    _build.raise_on_error(KERNEL_FWD, err)
    _build.count_launch(KERNEL_FWD)
    return out, lse


def _bwd_inputs(q, k, v, o, lse, do):
    _check(q, k, v, o, do)
    b, h, lq, _ = q.shape
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_bwd takes a contiguous (B, H, Lq) f32 LSE")
    q, k, v, do = (_build.tma_ready(x) for x in (q, k, v, do))
    return q, k, v, _build.kernel_ready(o), do


def _launch_dq(q, k, v, o, lse, do, bias):
    """The first half of K6 on CUDA tensors: D = rowsum(dO * O) (the
    prologue), then dQ in bf16, written in (B, Lq, H, Dh) memory order.
    Returns (dQ, D)."""
    q, k, v, o, do = _bwd_inputs(q, k, v, o, lse, do)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    bias_f, bias_strides = _bias_args(bias, q, lk)
    dq = torch.empty((b, lq, h, dh), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn(COUNT_DQ)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _ptr(bias_f), delta.data_ptr(),
            dq.data_ptr(), b, h, lq, lk,
            *[st for x in (q, k, v, o, do, dq) for st in x.stride()[:3]],
            *bias_strides, dh ** -0.5, stream)
    _build.raise_on_error(KERNEL_BWD, err)
    _build.count_launch(COUNT_DQ)
    return dq, delta


def _launch_dkv(q, k, v, o, lse, do, bias, delta):
    """The second half of K6 on CUDA tensors: bf16 (dK, dV) from the D
    that :func:`_launch_dq` computed, in (B, Lk, H, Dh) memory order."""
    q, k, v, o, do = _bwd_inputs(q, k, v, o, lse, do)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if delta.shape != (b, h, lq) or not delta.is_contiguous():
        raise ValueError("flash_bwd_dkv takes the contiguous (B, H, Lq) D "
                         "of the dQ launch")
    bias_f, bias_strides = _bias_args(bias, q, lk)
    dk = torch.empty((b, lk, h, dh), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn(COUNT_DKV)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias_f), dk.data_ptr(),
            dv.data_ptr(), b, h, lq, lk,
            *[st for x in (q, k, v, do, dk, dv) for st in x.stride()[:3]],
            *bias_strides, dh ** -0.5, stream)
    _build.raise_on_error(KERNEL_BWD, err)
    _build.count_launch(COUNT_DKV)
    return dk, dv


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of :func:`flash_attention`: K5 on CUDA tensors,
    :func:`flash_attention_reference` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    return _launch_fwd(q, k, v, bias)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) from the forward's O and LSE: K6 on CUDA tensors,
    :func:`flash_backward_reference` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, bias)
    dq, delta = _launch_dq(q, k, v, o, lse, do, bias)
    return (dq,) + _launch_dkv(q, k, v, o, lse, do, bias, delta)


class _FlashFunction(torch.autograd.Function):
    """Counterpart of the JAX ``flash_attention`` custom VJP: the forward
    saves q, k, v, the bias, O and LSE; the backward runs K6 (or its plain
    version on CPU tensors) and, only when the bias requires grad, the
    dense plain expression for the bias cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = flash_forward(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, bias)
        dbias = None
        if ctx.needs_input_grad[3]:
            with torch.enable_grad():
                b_ = bias.detach().requires_grad_(True)
                dbias, = torch.autograd.grad(
                    _plain_attention(q, k, v, b_), b_, do)
        return dq, dk, dv, dbias


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, Lq, Dh) x (B, H, Lk, Dh) -> (B, H, Lq, Dh) attention with an
    additive ``bias`` broadcastable from (B|1, H|1, 1|Lq, Lk);
    differentiable in q, k, v and the bias."""
    return _FlashFunction.apply(q, k, v, bias)
