"""Dense attention ops (counterpart of sasvqa_tpu/ops/attention.py).

Numerics follow the JAX package's XLA path: scores and softmax in f32,
probabilities cast to the input dtype for P@V, f32 accumulation, output
in the input dtype.  A bf16 x bf16 product is exact in f32, so upcasting
both operands and multiplying in f32 gives the f32-accumulated product.

Where the JAX package routes to its generic flash kernel (both lengths
>= 512 on the accelerator), :func:`dot_product_attention` routes CUDA
tensors to ``ops/flash_attention.py`` (K5/K6 as hand-written kernels);
that route runs the kernels or raises.  CPU tensors stay plain unless
``use_flash=True`` asks for the flash route, whose plain versions then run.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # additive-mask value, safe in bf16 (finfo.min overflows sums)

_FLASH_MIN_SEQ = 512


def _use_flash(q: torch.Tensor, k: torch.Tensor,
               explicit: Optional[bool]) -> bool:
    """The JAX ``_use_flash`` rule: an explicit choice wins; otherwise
    the flash kernels take CUDA tensors when both lengths reach 512."""
    if explicit is not None:
        return explicit
    return (q.shape[-2] >= _FLASH_MIN_SEQ and k.shape[-2] >= _FLASH_MIN_SEQ
            and q.device.type == "cuda")


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          use_flash: Optional[bool] = None) -> torch.Tensor:
    """Scaled dot-product attention, (B, H, L, Dh) layout; ``bias`` is
    additive and broadcastable to (B, H, Lq, Lk)."""
    if _use_flash(q, k, use_flash):
        from sasvqa_torch.ops.flash_attention import flash_attention
        if bias is not None:
            # the flash route reads the bias by rank-4 position; a
            # lower-rank bias gains leading axes
            while bias.dim() < 4:
                bias = bias[None]
        return flash_attention(q, k, v, bias)
    return _plain_attention(q, k, v, bias)


def _plain_attention(q, k, v, bias=None):
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(dtype).float(), v.float())
    return out.to(dtype)


def padding_bias(attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, Lk) 1/0 mask -> additive bias (B, 1, 1, Lk)."""
    return ((1.0 - attention_mask.float())
            * NEG_INF)[:, None, None, :].to(dtype)


def causal_bias(seq_len: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """(1, 1, L, L) additive causal bias (upper triangle masked)."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(j > i, zero + NEG_INF, zero)[None, None].to(dtype)
