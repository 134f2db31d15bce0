"""Cross-attention fusion head and answer classifier (counterpart of
sasvqa_tpu/models/fusion.py).

The reference's ``CrossAttentionLayer`` + ``CLIPForSeqClassification``
head: a zero "decoded token" is prepended to the text hidden states, a
post-LN transformer decoder (8 heads, d_ff = 4d) fuses them with the
per-frame video embeddings, and the classifier reads position 0.  Every
video in a batch contributes exactly ``nframe`` frames, so the frame
embeddings are a fixed-shape (B, T, D) tensor.  These attentions are
short (text length + 1 queries, T keys) and stay plain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sasvqa_torch.models.layers import (Dense, Dropout, LayerNorm,
                                        MultiHeadAttention)
from sasvqa_torch.ops.attention import padding_bias

# flax.linen.LayerNorm's default epsilon, used throughout the head
_LN_EPS = 1e-6


def _act(name: str):
    """relu, or flax's default (tanh) gelu."""
    return F.relu if name == "relu" else (
        lambda x: F.gelu(x, approximate="tanh"))


class TransformerDecoderLayer(nn.Module):
    """torch.nn.TransformerDecoderLayer semantics (post-LN, batch-first):
    self-attn -> +res -> LN1; cross-attn over ``memory`` (width
    ``memory_size``) -> +res -> LN2; FFN(act) -> +res -> LN3."""

    def __init__(self, d_model: int, memory_size: Optional[int] = None,
                 num_heads: int = 8, ffn_scale: int = 4,
                 activation: str = "relu", dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype=dtype)
        self.cross_attn = MultiHeadAttention(d_model, num_heads,
                                             kv_size=memory_size, dtype=dtype)
        self.linear1 = Dense(d_model, ffn_scale * d_model, dtype=dtype)
        self.linear2 = Dense(ffn_scale * d_model, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, _LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, _LN_EPS, dtype)
        self.norm3 = LayerNorm(d_model, _LN_EPS, dtype)
        self.drop = Dropout(dropout_rate)
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``tgt_key_padding_mask``: (B, L), 1 = valid (the inverse of the
        torch convention)."""
        bias = None
        if tgt_key_padding_mask is not None:
            bias = padding_bias(tgt_key_padding_mask, self.dtype)
        x = self.norm1(tgt + self.drop(self.self_attn(tgt, bias=bias),
                                       generator))
        x = self.norm2(x + self.drop(self.cross_attn(x, kv_states=memory),
                                     generator))
        h = self.drop(_act(self.activation)(self.linear1(x)), generator)
        return self.norm3(x + self.drop(self.linear2(h), generator))


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer semantics (post-LN)."""

    def __init__(self, d_model: int, num_heads: int = 8, ffn_scale: int = 4,
                 activation: str = "gelu", dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype=dtype)
        self.linear1 = Dense(d_model, ffn_scale * d_model, dtype=dtype)
        self.linear2 = Dense(ffn_scale * d_model, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, _LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, _LN_EPS, dtype)
        self.drop = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x), generator))
        h = self.drop(_act(self.activation)(self.linear1(x)), generator)
        return self.norm2(x + self.drop(self.linear2(h), generator))


class CrossAttentionFusion(nn.Module):
    """The reference CrossAttentionLayer's three variants, over text of
    width ``d_model`` and frame embeddings of width ``vis_size``:

    - ``dec-only`` (the default): ``n_layers`` stacked decoder layers, text
      as target, frame embeddings as memory;
    - ``enc-dec``: one encoder layer over the frames, then one decoder
      layer (``torch.nn.Transformer(1, 1, gelu)`` with its final
      encoder/decoder LayerNorms);
    - ``dec-cas``: one shared decoder layer applied per frame in a
      cascade (memory = one frame at a time).
    """

    def __init__(self, d_model: int, vis_size: Optional[int] = None,
                 num_heads: int = 8, n_layers: int = 1,
                 dropout_rate: float = 0.1, attn_type: str = "dec-only",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        vis_size = vis_size or d_model
        self.attn_type = attn_type
        self.n_layers = n_layers
        if attn_type == "enc-dec":
            self.encoder_0 = TransformerEncoderLayer(
                vis_size, num_heads, activation="gelu",
                dropout_rate=dropout_rate, dtype=dtype)
            self.encoder_norm = LayerNorm(vis_size, _LN_EPS, dtype)
            self.decoder_0 = TransformerDecoderLayer(
                d_model, vis_size, num_heads, activation="gelu",
                dropout_rate=dropout_rate, dtype=dtype)
            self.decoder_norm = LayerNorm(d_model, _LN_EPS, dtype)
        elif attn_type == "dec-cas":
            self.layers_0 = TransformerDecoderLayer(
                d_model, vis_size, num_heads, dropout_rate=dropout_rate,
                dtype=dtype)
        elif attn_type == "dec-only":
            for i in range(n_layers):
                self.add_module(f"layers_{i}", TransformerDecoderLayer(
                    d_model, vis_size, num_heads, dropout_rate=dropout_rate,
                    dtype=dtype))
        else:
            raise ValueError(f"unknown attn_type {attn_type!r}")

    def forward(self, txt_in: torch.Tensor, vis_in: torch.Tensor,
                txt_attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.attn_type == "enc-dec":
            mem = self.encoder_norm(self.encoder_0(vis_in, generator))
            # the reference passes the frames as src and the text as tgt
            out = self.decoder_0(txt_in, mem, txt_attn_mask, generator)
            return self.decoder_norm(out)
        if self.attn_type == "dec-cas":
            o = txt_in
            for t in range(vis_in.shape[1]):
                o = self.layers_0(o, vis_in[:, t:t + 1], txt_attn_mask,
                                  generator)
            return o
        x = txt_in
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, vis_in, txt_attn_mask,
                                             generator)
        return x


class AnswerClassifier(nn.Module):
    """Zero decoded token + fusion + classifier at position 0: text hidden
    states (B, L, D) with mask (B, L) and frame embeddings (B, T, Dv) ->
    f32 logits (B, num_labels).  ``classifier``: ``linear`` or ``mlp``
    (dense to ``cls_hidden_scale * D``, tanh-gelu, then the classifier)."""

    def __init__(self, d_model: int, num_labels: int,
                 vis_size: Optional[int] = None, num_heads: int = 8,
                 dropout_rate: float = 0.1, classifier: str = "linear",
                 cls_hidden_scale: int = 2, attn_type: str = "dec-only",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if classifier not in ("linear", "mlp"):
            raise ValueError(f"unknown classifier {classifier!r}")
        self.attention = CrossAttentionFusion(
            d_model, vis_size, num_heads, dropout_rate=dropout_rate,
            attn_type=attn_type, dtype=dtype)
        width = d_model
        self.cls_fc = None
        if classifier == "mlp":
            width = d_model * cls_hidden_scale
            self.cls_fc = Dense(d_model, width, dtype=dtype)
        self.classifier = Dense(width, num_labels, dtype=dtype)

    def forward(self, txt_hidden: torch.Tensor, txt_mask: torch.Tensor,
                vis_embeds: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, _, d = txt_hidden.shape
        txt_in = torch.cat([txt_hidden.new_zeros((b, 1, d)), txt_hidden],
                           dim=1)
        mask = torch.cat([txt_mask.new_ones((b, 1)), txt_mask], dim=1)
        pooled = self.attention(txt_in, vis_embeds, mask, generator)[:, 0]
        if self.cls_fc is not None:
            pooled = F.gelu(self.cls_fc(pooled), approximate="tanh")
        return self.classifier(pooled).float()
