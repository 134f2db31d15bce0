"""BLIP vision encoder and multimodal text encoder (counterpart of
sasvqa_tpu/models/blip.py).

The vision tower encodes frames at 384x384 with 16-pixel patches: 577
tokens a frame, so on the GPU each of its self-attention layers takes the
flash kernels (ops/flash_attention.py, K5/K6) through
``dot_product_attention``.  The text encoder is BERT-style and
cross-attends to the vision tokens in every layer.

HF quirks kept for weight parity:

- the vision ``pooler_output`` applies ``post_layernorm`` twice to the CLS
  token (once over the sequence, then again on the pooled slice);
- the text pooler is dense + tanh over position 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from sasvqa_torch.models.layers import (Dense, Dropout, Embed, LayerNorm,
                                        PatchEmbed, PostLNBlock, PreLNBlock,
                                        init_params)
from sasvqa_torch.ops.attention import padding_bias


@dataclasses.dataclass(frozen=True)
class BLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 384
    patch_size: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"

    @property
    def tokens_per_frame(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class BLIPTextConfig:
    vocab_size: int = 30524
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    dropout: float = 0.0
    encoder_width: int = 768  # vision hidden size for cross-attention


class BLIPVisionEncoder(nn.Module):
    """BLIP ViT: patch embedding with bias, CLS token, a raw learned
    position table, pre-LN blocks, post-LN over all tokens.  Weights are
    drawn from ``generator`` (default: seeded with 0).

    ``flash`` is the self-attention route: None (auto: the flash kernels
    on CUDA tensors at >= 512 tokens), or False (plain attention at any
    length, the oracle the kernel route is checked against)."""

    def __init__(self, config: BLIPVisionConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.flash: Optional[bool] = None
        self.patch_embedding = PatchEmbed(c.patch_size, c.hidden_size,
                                          use_bias=True, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(1, 1, c.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.empty(1, c.tokens_per_frame, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", PreLNBlock(
                c.hidden_size, c.num_heads, c.intermediate_size,
                c.hidden_act, c.layer_norm_eps, dtype))
        self.post_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                        dtype)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels (N, H, W, C) -> (hidden (N, P, D) post-LN, pooled CLS
        (N, D) post-LN twice)."""
        n = pixels.shape[0]
        patches = self.patch_embedding(pixels)
        cls = self.class_embedding.to(self.dtype).expand(n, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.to(self.dtype)[:, :x.shape[1]]
        for lyr in self.layers:
            x = lyr(x, use_flash=self.flash)
        x = self.post_layernorm(x)
        return x, self.post_layernorm(x[:, 0])


class BLIPTextEncoder(nn.Module):
    """BERT-style text encoder whose every layer also attends to encoder
    hidden states of width ``encoder_width``.  Weights are drawn from
    ``generator`` (default: seeded with 0)."""

    def __init__(self, config: BLIPTextConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings,
                                         c.hidden_size, dtype)
        self.emb_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.emb_drop = Dropout(c.dropout)
        self.dtype = dtype
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", PostLNBlock(
                c.hidden_size, c.num_heads, c.intermediate_size,
                c.hidden_act, c.layer_norm_eps, c.dropout,
                cross_attention=True, encoder_width=c.encoder_width,
                dtype=dtype))
        self.pooler = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                encoder_hidden: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids/attention_mask (B, L), encoder_hidden (B, M,
        encoder_width) -> (hidden (B, L, D), pooled (B, D)); ``generator``
        turns the dropouts on."""
        l = input_ids.shape[1]
        if l > self.config.max_position_embeddings:
            raise ValueError(f"text length {l} exceeds max_position_"
                             f"embeddings {self.config.max_position_embeddings}")
        pos = torch.arange(l, device=input_ids.device)[None, :]
        x = self.emb_ln(self.word_embeddings(input_ids)
                        + self.position_embeddings(pos))
        x = self.emb_drop(x, generator)
        bias = padding_bias(attention_mask, dtype=self.dtype)
        for lyr in self.layers:
            x = lyr(x, bias=bias, encoder_hidden=encoder_hidden,
                    generator=generator)
        return x, torch.tanh(self.pooler(x[:, 0]))
