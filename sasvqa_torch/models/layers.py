"""Shared transformer building blocks (counterpart of sasvqa_tpu/models/layers.py).

Submodules carry the Flax parameter paths' names (``qkv``, ``out_proj``,
``fc1``, ``layer_norm1``, ``intermediate``, ``ln``, ...), so a Flax param
tree maps onto these modules leaf by leaf (models/convert.py).

Dtype policy, as the JAX package's ``dtype=`` modules: parameters are
f32; :class:`Dense`, :class:`Embed` and :class:`LayerNorm` compute in
their ``dtype`` (bf16 when serving), LayerNorm statistics in f32.

Dropout draws from an explicit ``torch.Generator`` passed down the
forward (the counterpart of the flax ``dropout`` rng stream); without one
the forward is deterministic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sasvqa_torch.ops import layer_norm
from sasvqa_torch.ops.attention import dot_product_attention

# flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# result has std 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """``flax.linen.Dense`` counterpart: ``weight`` is (out, in) f32,
    inputs and parameters are cast to ``dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Dropout(nn.Module):
    """``flax.linen.Dropout`` counterpart: keeps each element with
    probability 1 - rate and scales it by 1/(1 - rate).  The Bernoulli
    mask comes from ``generator`` on the tensor's device;
    ``generator=None`` (or rate 0) returns the input unchanged."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` counterpart: mean and variance
    (E[x^2] - E[x]^2, clipped at 0) in f32, output cast to ``dtype``.
    CUDA tensors that ``ops/layer_norm.kernel_takes`` go through the
    hand-written kernels; everything else through :meth:`plain`, which
    the kernels are held against."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layer_norm.kernel_takes(x, self.weight, self.bias, self.dtype):
            return layer_norm.layer_norm(x, self.weight, self.bias, self.eps)
        return self.plain(x)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The formula in plain PyTorch, on any device."""
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


class Embed(nn.Module):
    """``flax.linen.Embed`` counterpart: a (num, features) table read in
    ``dtype``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the Flax defaults: Dense kernels lecun-normal,
    biases 0, LayerNorm 1/0, embeddings normal(1/sqrt(features)), a raw
    ``class_embedding`` or ``position_embedding`` parameter normal(0.02).
    Draws come from ``generator`` in module order, so a seed fixes every
    weight."""
    for m in module.modules():
        if isinstance(m, Dense):
            std = 1.0 / math.sqrt(m.weight.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Embed):
            nn.init.normal_(m.weight, std=m.weight.shape[1] ** -0.5,
                            generator=generator)
        for name, p in m.named_parameters(recurse=False):
            if name in ("class_embedding", "position_embedding"):
                nn.init.normal_(p, std=0.02, generator=generator)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU in f32; the tanh form for sub-f32 dtypes, as the JAX
    package does (the two differ by at most 1 bf16 ULP)."""
    if x.element_size() < 4:
        return _gelu_tanh(x)
    return F.gelu(x)


ACT2FN = {
    "gelu": _gelu_exact,
    "gelu_new": _gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "gelu_python": _gelu_exact,
    "gelu_pytorch_tanh": _gelu_tanh,
}


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, Dh), a view."""
    b, l, d = x.shape
    return x.view(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, D)"""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections.

    ``kv_states`` (width ``kv_size``, default ``hidden_size``) enables
    cross-attention; ``bias`` is additive, broadcastable to
    (B, H, Lq, Lk)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 kv_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        kv_size = kv_size or hidden_size
        self.q_proj = Dense(hidden_size, hidden_size, dtype=dtype)
        self.k_proj = Dense(kv_size, hidden_size, dtype=dtype)
        self.v_proj = Dense(kv_size, hidden_size, dtype=dtype)
        self.out_proj = Dense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, hidden: torch.Tensor,
                kv_states: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = hidden if kv_states is None else kv_states
        out = dot_product_attention(
            split_heads(self.q_proj(hidden), self.num_heads),
            split_heads(self.k_proj(kv), self.num_heads),
            split_heads(self.v_proj(kv), self.num_heads), bias=bias)
        return self.out_proj(merge_heads(out))


class FusedSelfAttention(nn.Module):
    """Self-attention with one fused (D, 3D) QKV projection."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(hidden_size, 3 * hidden_size, dtype=dtype)
        self.out_proj = Dense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, hidden: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                use_flash: Optional[bool] = None) -> torch.Tensor:
        q, k, v = self.qkv(hidden).chunk(3, dim=-1)
        out = dot_product_attention(
            split_heads(q, self.num_heads), split_heads(k, self.num_heads),
            split_heads(v, self.num_heads), bias=bias, use_flash=use_flash)
        return self.out_proj(merge_heads(out))


class MLP(nn.Module):
    """fc1 -> act -> fc2 (CLIP naming)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation: str = "quick_gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.fc1 = Dense(hidden_size, intermediate_size, dtype=dtype)
        self.fc2 = Dense(intermediate_size, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(ACT2FN[self.activation](self.fc1(x)))


class PreLNBlock(nn.Module):
    """CLIP-style encoder layer: LN -> attn -> +res ; LN -> MLP -> +res."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, activation: str = "quick_gelu",
                 layer_norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.self_attn = FusedSelfAttention(hidden_size, num_heads, dtype)
        self.layer_norm2 = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.mlp = MLP(hidden_size, intermediate_size, activation, dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                use_flash: Optional[bool] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias=bias,
                               use_flash=use_flash)
        return x + self.mlp(self.layer_norm2(x))


class BertFFN(nn.Module):
    """BERT feed-forward sub-block: dense -> act -> dense -> dropout ->
    +res -> LN."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation: str = "gelu", layer_norm_eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.activation = activation
        self.intermediate = Dense(hidden_size, intermediate_size, dtype=dtype)
        self.output = Dense(intermediate_size, hidden_size, dtype=dtype)
        self.drop = Dropout(dropout_rate)
        self.ln = LayerNorm(hidden_size, layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = ACT2FN[self.activation](self.intermediate(x))
        return self.ln(x + self.drop(self.output(h), generator))


class BertSelfAttention(nn.Module):
    """BERT attention sub-block: MHA -> dense -> dropout -> +res -> LN.

    ``kv_size`` is the width of ``kv_states`` for cross-attention
    (default ``hidden_size``); ``key``/``value`` project it into the
    QUERY side's width, as HF BertSelfAttention does (blip-large's
    1024-wide vision under a 768-wide text stack)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 layer_norm_eps: float = 1e-12, dropout_rate: float = 0.0,
                 kv_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        kv_size = kv_size or hidden_size
        self.query = Dense(hidden_size, hidden_size, dtype=dtype)
        self.key = Dense(kv_size, hidden_size, dtype=dtype)
        self.value = Dense(kv_size, hidden_size, dtype=dtype)
        self.out_dense = Dense(hidden_size, hidden_size, dtype=dtype)
        self.drop = Dropout(dropout_rate)
        self.out_ln = LayerNorm(hidden_size, layer_norm_eps, dtype)

    def project_kv(self, hidden: torch.Tensor):
        """K/V heads of ``hidden``, projected into the query width."""
        return (split_heads(self.key(hidden), self.num_heads),
                split_heads(self.value(hidden), self.num_heads))

    def forward(self, hidden: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                kv_states: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        q = split_heads(self.query(hidden), self.num_heads)
        k, v = self.project_kv(hidden if kv_states is None else kv_states)
        ctx = merge_heads(dot_product_attention(q, k, v, bias=bias))
        out = self.drop(self.out_dense(ctx), generator)
        return self.out_ln(hidden + out)


class PostLNBlock(nn.Module):
    """BERT-style encoder layer (BLIP text): self-attention, an optional
    cross-attention sub-block over ``encoder_hidden`` (width
    ``encoder_width``), then the FFN."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, activation: str = "gelu",
                 layer_norm_eps: float = 1e-12, dropout_rate: float = 0.0,
                 cross_attention: bool = False,
                 encoder_width: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = BertSelfAttention(hidden_size, num_heads,
                                           layer_norm_eps, dropout_rate,
                                           dtype=dtype)
        self.crossattention = (
            BertSelfAttention(hidden_size, num_heads, layer_norm_eps,
                              dropout_rate, kv_size=encoder_width,
                              dtype=dtype) if cross_attention else None)
        self.ffn = BertFFN(hidden_size, intermediate_size, activation,
                           layer_norm_eps, dtype, dropout_rate)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                encoder_hidden: Optional[torch.Tensor] = None,
                encoder_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.attention(x, bias=bias, generator=generator)
        if self.crossattention is not None:
            if encoder_hidden is None:
                raise ValueError("a cross-attention layer needs "
                                 "encoder_hidden")
            x = self.crossattention(x, bias=encoder_bias,
                                    kv_states=encoder_hidden,
                                    generator=generator)
        return self.ffn(x, generator)


class PatchEmbed(nn.Module):
    """ViT patch embedding as an unfold + matmul over NHWC pixels, in the
    (ph, pw, c) flatten order of the JAX package (equivalent to the
    stride-p convolution of the HF models)."""

    def __init__(self, patch_size: int, embed_dim: int, in_channels: int = 3,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(patch_size * patch_size * in_channels, embed_dim,
                          use_bias=use_bias, dtype=dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, h, w, c = pixels.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = pixels.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(b, gh * gw, p * p * c))
