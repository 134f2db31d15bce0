"""CLIP vision encoder (counterpart of sasvqa_tpu/models/clip.py).

HF ``CLIPVisionModel`` semantics over NHWC pixels: patch embedding, class
token, position embedding, pre-LN, pre-LN encoder blocks, post-LN of the
CLS token (or of every token, as GIT uses it).  The CLIP text encoder
comes with the classifier families.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from sasvqa_torch.models.layers import (Dense, Embed, LayerNorm, PatchEmbed,
                                        PreLNBlock, init_params)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


CLIP_VIT_L14_VISION = CLIPVisionConfig(hidden_size=1024,
                                       intermediate_size=4096, num_layers=24,
                                       num_heads=16, patch_size=14,
                                       projection_dim=768)


class CLIPVisionEncoder(nn.Module):
    """``post_ln_all_tokens``: GIT post-LNs every token, plain CLIP only
    the CLS.  ``with_projection`` adds the bias-free visual projection.
    Weights are drawn from ``generator`` (default: seeded with 0)."""

    def __init__(self, config: CLIPVisionConfig,
                 dtype: torch.dtype = torch.float32,
                 post_ln_all_tokens: bool = False,
                 with_projection: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.post_ln_all_tokens = post_ln_all_tokens
        self.patch_embedding = PatchEmbed(c.patch_size, c.hidden_size,
                                          use_bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        num_pos = (c.image_size // c.patch_size) ** 2 + 1
        self.position_embedding = Embed(num_pos, c.hidden_size, dtype)
        self.pre_layrnorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.num_layers = c.num_layers
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", PreLNBlock(
                c.hidden_size, c.num_heads, c.intermediate_size,
                c.hidden_act, c.layer_norm_eps, dtype))
        self.post_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                        dtype)
        self.visual_projection = (
            Dense(c.hidden_size, c.projection_dim, use_bias=False,
                  dtype=dtype) if with_projection else None)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """pixels: (N, H, W, C).  Returns (last_hidden_state (N, P+1, D),
        pooled_cls (N, D), image_embeds (N, proj) or None)."""
        n = pixels.shape[0]
        patches = self.patch_embedding(pixels)
        cls = self.class_embedding.to(self.dtype).expand(n, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self.pre_layrnorm(x + self.position_embedding(pos))
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        if self.post_ln_all_tokens:
            x = self.post_layernorm(x)
            pooled = x[:, 0]
        else:
            pooled = self.post_layernorm(x[:, 0])
        image_embeds = None
        if self.visual_projection is not None:
            image_embeds = self.visual_projection(pooled)
        return x, pooled, image_embeds
