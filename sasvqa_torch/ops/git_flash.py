"""GIT-mask flash attention, forward and backward (counterpart of
sasvqa_tpu/ops/git_flash.py).

The GIT combined mask (image rows attend image columns only; text rows
attend every image column plus causal text columns, minus text padding)
is a function of ``num_img`` and the (B, L) text padding mask.
:func:`git_flash_attention` computes attention under it without ever
building the (S, S) mask, with optional attention-probability dropout
drawn from a coordinate hash (:func:`hash_dropout_factor`), and is
differentiable through :class:`_GitFlashFunction`:

- CUDA tensors launch the hand-written Hopper kernels
  ``csrc/git_flash_fwd.cu`` (K1, replaces the Pallas TPU kernel
  ``_fwd_kernel``) and, for the backward, ``csrc/git_flash_bwd.cu`` (K2,
  replaces ``_fused_bwd_kernel``: one pass, dQ summed into an f32
  workspace by TMA reductions) or ``csrc/git_flash_bwd_split.cu`` (K3,
  replaces ``_dq_kernel``/``_dkv_kernel``), as :data:`FUSED_BWD`
  routes them; all regenerate the dropout mask in-kernel (``hash_keep``
  in ``csrc/git_flash_common.cuh``, replacing ``_hash_keep``).  A CUDA
  tensor the kernels cannot take raises;
- CPU tensors take :func:`git_flash_attention_reference` and
  :func:`git_flash_backward_reference` (fused numerics) or
  :func:`git_flash_backward_split_reference` (split numerics), the plain
  PyTorch versions of the same functions, which the tests hold against
  the JAX package and the kernels are held against on the card.

The forward returns ``(O, LSE)``: O in the input dtype (B, H, S, Dh),
LSE in f32 (B, H, S); LSE is not differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import NEG_INF

KERNEL = "git_flash_fwd"
KERNEL_BWD = "git_flash_bwd"
KERNEL_BWD_REDUCE = "git_flash_bwd_reduce_only"
KERNEL_SPLIT = "git_flash_bwd_split"
COUNT_DQ, COUNT_DKV = "git_flash_bwd_dq", "git_flash_bwd_dkv"
HEAD_DIM = 64

SeedLike = Union[int, torch.Tensor, None]

_fns = {}

# ---- K4: coordinate-hash attention-probability dropout --------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32) and a uint32
    constant ``c``, without overflowing int64: the product is split at
    16 bits of ``c`` (each partial product stays below 2^48)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash_keep(bh: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout factor {0, 1/(1-rate)} as f32, bit for bit the JAX
    ``_hash_keep``: a lowbias32-style finalizer of the element's
    (b*H + h, row, col) coordinates plus the seed, in uint32 arithmetic
    (wrapping multiplies, logical shifts) emulated in int64."""
    h = ((seed.to(torch.int64) & _M32) + _mul32(bh, 0x9E3779B9)
         + _mul32(rows, 0x85EBCA6B) + _mul32(cols, 0xC2B2AE35)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    r = h & 0x7FFFFFFF                    # 31 uniform bits
    thresh, inv_keep = _dropout_consts(rate)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return torch.where(r >= thresh, zero + inv_keep, zero)


def _dropout_consts(rate: float) -> Tuple[int, float]:
    """(threshold on the 31 hash bits, f32 keep scale), as the JAX
    kernel computes them."""
    return int(rate * (1 << 31)), float(np.float32(1.0 / (1.0 - rate)))


def _seed_tensor(seed: SeedLike, device: torch.device) -> torch.Tensor:
    """The dropout seed as a (1,) int32 tensor on ``device`` (0 when
    unset).  The kernels read it on the device: a tensor seed drawn there
    and an int seed filled in there need no host copy or sync."""
    if seed is None:
        seed = 0
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.int32)
    wrapped = (int(seed) + (1 << 31)) % (1 << 32) - (1 << 31)
    return torch.full((1,), wrapped, dtype=torch.int32, device=device)


def hash_dropout_factor(b: int, h: int, s: int, seed: SeedLike, rate: float,
                        device=None) -> torch.Tensor:
    """(B, H, S, S) f32 factor tensor from the same hash as the kernels:
    the dense training path's mask and the tests' oracle."""
    dev = torch.device(device) if device is not None else (
        seed.device if isinstance(seed, torch.Tensor) else
        torch.device("cpu"))
    bh = torch.arange(b * h, dtype=torch.int64, device=dev)[:, None, None]
    idx = torch.arange(s, dtype=torch.int64, device=dev)
    return _hash_keep(bh, idx[None, :, None], idx[None, None, :],
                      _seed_tensor(seed, dev).reshape(()),
                      rate).reshape(b, h, s, s)


def dense_attention_with_hash_dropout(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      bias: Optional[torch.Tensor],
                                      seed: SeedLike,
                                      rate: float) -> torch.Tensor:
    """Dense attention applying the kernels' exact dropout mask (the
    training path off the git-flash route): f32 scores and softmax, the
    factor on the normalised probabilities, P in the input dtype for P@V
    with f32 accumulation.  Differentiable by autograd."""
    b, h, s, dh = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * dh ** -0.5
    if bias is not None:
        scores = scores + bias.float()
    p = torch.softmax(scores, dim=-1) * hash_dropout_factor(
        b, h, s, seed, rate, device=q.device)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


# ---- plain versions of the kernels ----------------------------------------

def git_mask_ok(num_img: int, attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, S, S) bool: True where row r may attend column c, exactly as
    the JAX kernel's ``_mask_ok``."""
    b, l = attention_mask.shape
    s = num_img + l
    dev = attention_mask.device
    idx = torch.arange(s, device=dev)
    rows, cols = idx[:, None], idx[None, :]
    col_img = cols < num_img
    colmask = torch.cat([torch.ones((b, num_img), dtype=torch.bool,
                                    device=dev),
                         attention_mask != 0], dim=1)          # (B, S)
    text_ok = col_img | ((cols <= rows) & colmask[:, None, :])
    return torch.where(rows >= num_img, text_ok, col_img)


def _masked_scores(q, k, attention_mask, num_img):
    """f32 scores scaled after QK^T, plus the additive NEG_INF mask."""
    ok = git_mask_ok(num_img, attention_mask)[:, None]          # (B,1,S,S)
    zero = torch.zeros((), device=q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    return s + torch.where(ok, zero, zero + NEG_INF)


def git_flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  attention_mask: torch.Tensor,
                                  num_img: int, rate: float = 0.0,
                                  seed: SeedLike = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: f32 masked scores,
    f32 softmax statistics, the unnormalised P times the dropout factor
    (after l = rowsum(P) is taken, so l and LSE stay unmasked) cast to the
    input dtype for P@V with f32 accumulation, then O = acc / l and
    LSE = m + log(l)."""
    s = _masked_scores(q, k, attention_mask, num_img)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        b, h, n, _ = q.shape
        p = p * hash_dropout_factor(b, h, n, seed, rate, device=q.device)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _backward_plain(q, k, v, o, lse, do, attention_mask, num_img, rate,
                    seed, scale_after: bool):
    """The plain backward; ``scale_after`` takes the split kernels'
    numerics (scale after the f32 sums), else the fused kernel's."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_masked_scores(q, k, attention_mask, num_img)
                  - lse[..., None])
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    if rate > 0.0:
        b, h, n, _ = q.shape
        keep = hash_dropout_factor(b, h, n, seed, rate, device=q.device)
        dv = torch.matmul((p * keep).to(dt).float().transpose(-1, -2), dof)
        dp = dp * keep
    else:
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    d_row = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - d_row)
    if scale_after:
        ds = ds.to(dt).float()
        dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
        dq = torch.matmul(ds, k.float()) * scale
    else:
        ds = (ds * scale).to(dt).float()
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
        dq = torch.matmul(ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def git_flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor,
                                 attention_mask: torch.Tensor, num_img: int,
                                 rate: float = 0.0, seed: SeedLike = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of the fused backward kernel, with its
    numerics (JAX ``_fused_bwd_kernel``): P = exp(S - LSE) recomputed;
    dV = (P*keep)^T dO; dP = (dO V^T)*keep; D = rowsum(dO*O) over the
    dropped O; dS = P*(dP - D)*scale cast to the input dtype; dK = dS^T Q
    and dQ = dS K with f32 accumulation, cast at the end."""
    return _backward_plain(q, k, v, o, lse, do, attention_mask, num_img,
                           rate, seed, scale_after=False)


def git_flash_backward_split_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, o: torch.Tensor,
                                       lse: torch.Tensor, do: torch.Tensor,
                                       attention_mask: torch.Tensor,
                                       num_img: int, rate: float = 0.0,
                                       seed: SeedLike = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch version of the split backward kernels, with their
    numerics (JAX ``_dq_kernel``/``_dkv_kernel``): as
    :func:`git_flash_backward_reference`, but dS = P*(dP - D) is cast to
    the input dtype unscaled and the scale multiplies the f32 sums
    dQ = dS K and dK = dS^T Q.  With Dh = 64 the scale is a power of two,
    so the two orders round alike."""
    return _backward_plain(q, k, v, o, lse, do, attention_mask, num_img,
                           rate, seed, scale_after=True)


# ---- the CUDA kernels ------------------------------------------------------

# K1's tile: query rows a CTA and keys a tile (FWD_BM, FWD_BN in
# csrc/flash_fwd_sm90.cuh)
FWD_BLOCK_M, FWD_BLOCK_N = 64, 64


def fwd_tile_plan(num_img: int, s: int, block_m: int = FWD_BLOCK_M,
                  block_n: int = FWD_BLOCK_N
                  ) -> Dict[int, List[Tuple[int, bool]]]:
    """K1's visit-and-skip rule, as ``csrc/flash_fwd_sm90.cuh`` applies
    it: query tile start q0 -> the key tiles it visits, as (k0, masked).
    A query tile visits the key tiles below kv_end = min(S, max(num_img,
    q0 + block_m)), past which none of its rows attends a column; a key
    tile wholly below num_img (k0 + block_n <= num_img) is attendable from
    every row and runs no mask code (the TPU kernel's unmasked prefix,
    ``_n_unmasked_blocks``)."""
    plan = {}
    for q0 in range(0, s, block_m):
        kv_end = min(s, max(num_img, q0 + block_m))
        plan[q0] = [(k0, k0 + block_n > num_img)
                    for k0 in range(0, kv_end, block_n)]
    return plan


def bwd_tile_plan(num_img: int, s: int, block_m: int = FWD_BLOCK_M,
                  block_n: int = FWD_BLOCK_N
                  ) -> Dict[int, List[Tuple[int, bool]]]:
    """The visit-and-skip rule of K3's dK/dV program, as
    ``csrc/flash_bwd_sm90.cuh`` applies it: key tile start k0 -> the query
    tiles it visits, as (q0, masked).  A key tile of text keys only
    (k0 >= num_img) is attended by no row before its first key, so it
    starts at the query tile holding row k0; any other key tile visits
    every query tile.  A key tile wholly below num_img is attendable from
    every row and runs no mask code.  (The dQ program visits the key
    tiles of :func:`fwd_tile_plan`; K2's fused program visits the plan
    with ``block_n=FUSED_BLOCK_N``.)"""
    plan = {}
    for k0 in range(0, s, block_n):
        q_begin = k0 // block_m * block_m if k0 >= num_img else 0
        plan[k0] = [(q0, k0 + block_n > num_img)
                    for q0 in range(q_begin, s, block_m)]
    return plan


# K2's key tile: two 64-key halves, one a consumer warpgroup (FUSED_BN in
# csrc/flash_bwd_sm90.cuh).  Its plan is :func:`bwd_tile_plan` with
# ``block_n=FUSED_BLOCK_N``; a 64-key half wholly below num_img runs no
# mask code.
FUSED_BLOCK_N = 128


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(KERNEL_SPLIT if name in (COUNT_DQ, COUNT_DKV)
                          else KERNEL_BWD if name == KERNEL_BWD_REDUCE
                          else name)
        if name == KERNEL:
            fn = lib.git_flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 12
                           + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_uint32, ctypes.c_float,
                              ctypes.c_void_p])
        elif name in (KERNEL_BWD, KERNEL_BWD_REDUCE):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 24
                           + [ctypes.c_float, ctypes.c_uint32,
                              ctypes.c_float, ctypes.c_void_p])
        else:   # git_flash_bwd_dq / git_flash_bwd_dkv: one argument layout
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 18
                           + [ctypes.c_float, ctypes.c_uint32,
                              ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(attention_mask, num_img, *xs):
    _build.refuse_dtensor(attention_mask, *xs)
    q = xs[0]
    if not (all(x.is_cuda for x in xs) and attention_mask.is_cuda):
        raise ValueError("git_flash kernels need every tensor on the GPU")
    if any(x.dtype != torch.bfloat16 for x in xs):
        raise ValueError("git_flash kernels take bf16 q/k/v, got "
                         + "/".join(str(x.dtype) for x in xs))
    if q.dim() != 4 or any(x.shape != q.shape for x in xs):
        raise ValueError("q/k/v must share one (B, H, S, Dh) shape, got "
                         + "/".join(str(tuple(x.shape)) for x in xs))
    b, h, s, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"git_flash kernels take Dh={HEAD_DIM}, got {dh}")
    if attention_mask.dim() != 2 or attention_mask.shape[0] != b \
            or num_img + attention_mask.shape[1] != s:
        raise ValueError(f"attention_mask {tuple(attention_mask.shape)} "
                         f"does not fit B={b}, S={s}, num_img={num_img}")
    if num_img < 1:
        raise ValueError("git_flash kernels need num_img >= 1")


def _launch(q, k, v, attention_mask, num_img, rate=0.0, seed=None):
    """K1 (with K4 inside when ``rate`` > 0) on CUDA tensors."""
    _check(attention_mask, num_img, q, k, v)
    b, h, s, dh = q.shape
    q, k, v = (_build.tma_ready(x) for x in (q, k, v))
    text_mask = attention_mask.to(torch.int32).contiguous()
    seed_t = _seed_tensor(seed, q.device)
    thresh, inv_keep = _dropout_consts(rate)
    # O is written as (B, S, H, Dh) so that merge_heads is a free reshape
    out = torch.empty((b, s, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel_fn(KERNEL)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), text_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, s, num_img,
            attention_mask.shape[1], *strides, dh ** -0.5,
            seed_t.data_ptr(), thresh, inv_keep, stream)
    _build.raise_on_error(KERNEL, err)
    _build.count_launch(KERNEL)
    if rate > 0.0:
        _build.count_launch(_build.HASH_DROPOUT)
    return out, lse


def _check_bwd(q, k, v, o, lse, do, attention_mask, num_img):
    _check(attention_mask, num_img, q, k, v, o, do)
    b, h, s, _ = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("git_flash backward takes a contiguous (B, H, S) "
                         "f32 LSE")


def _run_fused(entry, q, k, v, o, lse, do, attention_mask, num_img, rate,
               seed):
    """Launches the fused program's C entry ``entry`` on CUDA tensors and
    returns (the f32 dQ workspace, dK, dV)."""
    _check_bwd(q, k, v, o, lse, do, attention_mask, num_img)
    b, h, s, dh = q.shape
    q, k, v, do = (_build.tma_ready(x) for x in (q, k, v, do))
    o = _build.kernel_ready(o)
    text_mask = attention_mask.to(torch.int32).contiguous()
    seed_t = _seed_tensor(seed, q.device)
    thresh, inv_keep = _dropout_consts(rate)
    # gradients are written as (B, S, H, Dh): the backward of split_heads
    # is then a free reshape
    shape = (b, s, h, dh)
    dq_acc = torch.zeros(shape, dtype=torch.float32,
                         device=q.device).transpose(1, 2)
    dk = torch.empty(shape, dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty(shape, dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for x in (q, k, v, o, do, dq_acc, dk, dv)
               for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel_fn(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), text_mask.data_ptr(),
            seed_t.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, h, s, num_img,
            attention_mask.shape[1], *strides, dh ** -0.5, thresh,
            inv_keep, stream)
    _build.raise_on_error(KERNEL_BWD, err)
    return dq_acc, dk, dv


def _launch_bwd(q, k, v, o, lse, do, attention_mask, num_img, rate=0.0,
                seed=None):
    """K2 (with K4 inside when ``rate`` > 0) on CUDA tensors: returns
    (dQ, dK, dV) in bf16.  dQ is summed over 128 keys at a time into a
    zeroed f32 workspace by TMA reductions and cast afterwards; the fill
    and the cast are part of K2's time."""
    dq_acc, dk, dv = _run_fused(KERNEL_BWD, q, k, v, o, lse, do,
                                attention_mask, num_img, rate, seed)
    _build.count_launch(KERNEL_BWD)
    if rate > 0.0:
        _build.count_launch(_build.HASH_DROPOUT)
    return dq_acc.to(q.dtype), dk, dv


def _launch_bwd_reduce_only(q, k, v, o, lse, do, attention_mask, num_img,
                            rate=0.0, seed=None):
    """K2's launch with its products and elementwise work compiled out:
    the D prologue, the ring, the dQ staging and the reductions of zero
    tiles (``git_flash_bwd_reduce_only``), at K2's grid and tile plan.  A
    measurement of what the dQ reduction costs, counted nowhere; returns
    the f32 workspace."""
    return _run_fused(KERNEL_BWD_REDUCE, q, k, v, o, lse, do,
                      attention_mask, num_img, rate, seed)[0]


def _launch_bwd_dq(q, k, v, o, lse, do, attention_mask, num_img, rate=0.0,
                   seed=None):
    """The first kernel of K3 on CUDA tensors: D = rowsum(dO * O) (the
    prologue), then dQ in bf16, written once in (B, S, H, Dh) memory
    order.  Returns (dQ, D)."""
    _check_bwd(q, k, v, o, lse, do, attention_mask, num_img)
    b, h, s, dh = q.shape
    q, k, v, do = (_build.tma_ready(x) for x in (q, k, v, do))
    o = _build.kernel_ready(o)
    text_mask = attention_mask.to(torch.int32).contiguous()
    seed_t = _seed_tensor(seed, q.device)
    thresh, inv_keep = _dropout_consts(rate)
    dq = torch.empty((b, s, h, dh), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for x in (q, k, v, o, do, dq) for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel_fn(COUNT_DQ)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), text_mask.data_ptr(),
            seed_t.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, s,
            num_img, attention_mask.shape[1], *strides, dh ** -0.5, thresh,
            inv_keep, stream)
    _build.raise_on_error(KERNEL_SPLIT, err)
    _build.count_launch(COUNT_DQ)
    if rate > 0.0:
        _build.count_launch(_build.HASH_DROPOUT)
    return dq, delta


def _launch_bwd_dkv(q, k, v, lse, do, attention_mask, num_img, delta,
                    rate=0.0, seed=None):
    """The second kernel of K3 on CUDA tensors: bf16 (dK, dV) from the D
    that :func:`_launch_bwd_dq` computed, in (B, S, H, Dh) memory order."""
    _check_bwd(q, k, v, q, lse, do, attention_mask, num_img)
    b, h, s, dh = q.shape
    if delta.shape != (b, h, s) or delta.dtype != torch.float32 \
            or not delta.is_contiguous():
        raise ValueError("git_flash_bwd_dkv takes a contiguous (B, H, S) "
                         "f32 D")
    q, k, v, do = (_build.tma_ready(x) for x in (q, k, v, do))
    text_mask = attention_mask.to(torch.int32).contiguous()
    seed_t = _seed_tensor(seed, q.device)
    thresh, inv_keep = _dropout_consts(rate)
    shape = (b, s, h, dh)
    dk = torch.empty(shape, dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty(shape, dtype=q.dtype, device=q.device).transpose(1, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for x in (q, k, v, do, dk, dv) for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel_fn(COUNT_DKV)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), text_mask.data_ptr(),
            seed_t.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s,
            num_img, attention_mask.shape[1], *strides, dh ** -0.5, thresh,
            inv_keep, stream)
    _build.raise_on_error(KERNEL_SPLIT, err)
    _build.count_launch(COUNT_DKV)
    if rate > 0.0:
        _build.count_launch(_build.HASH_DROPOUT)
    return dk, dv


def _launch_bwd_split(q, k, v, o, lse, do, attention_mask, num_img,
                      rate=0.0, seed=None):
    """K3 (with K4 inside both kernels when ``rate`` > 0) on CUDA tensors:
    returns (dQ, dK, dV) in bf16, each written once, no atomics."""
    dq, delta = _launch_bwd_dq(q, k, v, o, lse, do, attention_mask,
                               num_img, rate, seed)
    dk, dv = _launch_bwd_dkv(q, k, v, lse, do, attention_mask, num_img,
                             delta, rate, seed)
    return dq, dk, dv


# The backward's route, as the JAX package's module flag: True sends every
# backward through the fused kernel (K2), False through the split kernels
# (K3).  K2 took less device time than K3 at every length and rate that
# chip_smoke.py measures (split_kernels: S = 604, 1608, 3184 and 4144,
# rates 0 and 0.1, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), so the route
# holds no length crossover.
FUSED_BWD = True


def git_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       attention_mask: torch.Tensor, num_img: int,
                       rate: float = 0.0, seed: SeedLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of :func:`git_flash_attention` from its saved O and
    LSE, routed by :data:`FUSED_BWD`: K2 or K3 on CUDA tensors,
    :func:`git_flash_backward_reference` or
    :func:`git_flash_backward_split_reference` on CPU tensors."""
    _build.refuse_dtensor(q, k, v, o, lse, do, attention_mask)
    args = (q, k, v, o, lse, do, attention_mask, num_img, rate, seed)
    fused = FUSED_BWD
    if q.device.type == "cpu":
        return (git_flash_backward_reference(*args) if fused
                else git_flash_backward_split_reference(*args))
    return _launch_bwd(*args) if fused else _launch_bwd_split(*args)


class _GitFlashFunction(torch.autograd.Function):
    """Counterpart of the JAX ``_git_flash_core`` custom VJP: the forward
    saves q, k, v, O, LSE, the mask and the seed; the backward is
    :func:`git_flash_backward` (K2 or K3 on CUDA tensors, their plain
    versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask, num_img, rate, seed):
        if q.device.type == "cpu":
            out, lse = git_flash_attention_reference(
                q, k, v, attention_mask, num_img, rate, seed)
        else:
            out, lse = _launch(q, k, v, attention_mask, num_img, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse, attention_mask, seed)
        ctx.num_img, ctx.rate = num_img, rate
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, attention_mask, seed = ctx.saved_tensors
        dq, dk, dv = git_flash_backward(q, k, v, out, lse, do,
                                        attention_mask, ctx.num_img,
                                        ctx.rate, seed)
        return dq, dk, dv, None, None, None, None


def git_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attention_mask: torch.Tensor, num_img: int,
                        rate: float = 0.0, seed: SeedLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, S, Dh) self-attention under the GIT combined mask.

    attention_mask: (B, L) text padding mask, S = num_img + L.  ``rate``
    > 0 applies attention-probability dropout with the coordinate hash;
    ``seed`` (an int32 value or a one-element int tensor, varied per
    layer and step) is then required.  Returns (O (B, H, S, Dh) in q's
    dtype, LSE (B, H, S) f32); O is differentiable in q, k and v."""
    _build.refuse_dtensor(q, k, v, attention_mask)
    if rate > 0.0 and seed is None:
        raise ValueError("rate > 0 requires a dropout seed")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return _GitFlashFunction.apply(q, k, v, attention_mask, num_img,
                                   float(rate),
                                   _seed_tensor(seed, q.device))
