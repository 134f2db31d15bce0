"""GIT-mask flash-attention forward (counterpart of sasvqa_tpu/ops/git_flash.py).

The GIT combined mask (image rows attend image columns only; text rows
attend every image column plus causal text columns, minus text padding)
is a function of ``num_img`` and the (B, L) text padding mask.
:func:`git_flash_attention` computes attention under it without ever
building the (S, S) mask:

- CUDA tensors launch the hand-written Hopper kernel
  ``csrc/git_flash_fwd.cu`` (it replaces the Pallas TPU kernel
  ``_fwd_kernel``); a CUDA tensor the kernel cannot take raises;
- CPU tensors take :func:`git_flash_attention_reference`, the plain
  PyTorch version of the same function, which the tests hold against the
  JAX package and the kernel is held against on the card.

Both return ``(O, LSE)``: O in the input dtype (B, H, S, Dh), LSE in f32
(B, H, S).  Attention-probability dropout (ROADMAP K4) comes with the
training slice; ``rate > 0`` raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sasvqa_torch.ops import _build
from sasvqa_torch.ops.attention import NEG_INF

KERNEL = "git_flash_fwd"
HEAD_DIM = 64

_fn = None


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


def git_flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  attention_mask: torch.Tensor,
                                  num_img: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: f32 scores scaled after QK^T,
    additive NEG_INF mask, f32 softmax statistics, unnormalised P cast to
    the input dtype for P@V with f32 accumulation, then O = acc / l and
    LSE = m + log(l)."""
    scale = q.shape[-1] ** -0.5
    ok = git_mask_ok(num_img, attention_mask)[:, None]          # (B,1,S,S)
    zero = torch.zeros((), device=q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + torch.where(ok, zero, zero + NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL).git_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """A (B, H, S, 64) view the kernel can read through its strides:
    unit stride on Dh, 16-byte aligned rows.  Anything else is copied."""
    aligned = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in x.stride()[:-1]))
    return x if aligned else x.contiguous()


def _launch(q, k, v, attention_mask, num_img):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and attention_mask.is_cuda):
        raise ValueError("git_flash kernel needs every tensor on the GPU")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"git_flash kernel takes bf16 q/k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, H, S, Dh) shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    b, h, s, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"git_flash kernel takes Dh={HEAD_DIM}, got {dh}")
    if attention_mask.dim() != 2 or attention_mask.shape[0] != b \
            or num_img + attention_mask.shape[1] != s:
        raise ValueError(f"attention_mask {tuple(attention_mask.shape)} "
                         f"does not fit B={b}, S={s}, num_img={num_img}")
    if num_img < 1:
        raise ValueError("git_flash kernel needs num_img >= 1")
    l = attention_mask.shape[1]
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    text_mask = attention_mask.to(torch.int32).contiguous()
    # O is written as (B, S, H, Dh) so that merge_heads is a free reshape
    out = torch.empty((b, s, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           text_mask.data_ptr(), out.data_ptr(),
                           lse.data_ptr(), b, h, s, num_img, l, *strides,
                           dh ** -0.5, stream)
    if err != 0:
        lib = _build.load(KERNEL)
        lib.git_flash_error_string.restype = ctypes.c_char_p
        lib.git_flash_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError("git_flash_fwd launch failed: "
                           + lib.git_flash_error_string(err).decode())
    _build.count_launch(KERNEL)
    return out, lse


def git_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attention_mask: torch.Tensor, num_img: int,
                        rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, S, Dh) self-attention under the GIT combined mask.

    attention_mask: (B, L) text padding mask, S = num_img + L.  Returns
    (O (B, H, S, Dh) in q's dtype, LSE (B, H, S) f32)."""
    if rate > 0.0:
        raise NotImplementedError(
            "attention-probability dropout (ROADMAP K4) comes with the "
            "training slice")
    if q.device.type == "cpu":
        return git_flash_attention_reference(q, k, v, attention_mask,
                                             num_img)
    return _launch(q, k, v, attention_mask, num_img)
