"""CLIP text and vision encoders (counterpart of sasvqa_tpu/models/clip.py).

- text tower = HF ``CLIPTextModel``: token + position embeddings, pre-LN
  encoder blocks under a causal plus padding bias, final LN, pooled at
  the first EOS token (the last position when a row has none), optionally
  projected (no bias) into the shared embedding space;
- vision tower = HF ``CLIPVisionModel`` over NHWC pixels: patch
  embedding, class token, position embedding, pre-LN, pre-LN encoder
  blocks, post-LN of the CLS token (or of every token, as GIT uses it),
  optionally projected (no bias) to the per-frame embedding.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from sasvqa_torch.models.layers import (Dense, Embed, LayerNorm, PatchEmbed,
                                        PreLNBlock, init_params)
from sasvqa_torch.ops.attention import causal_bias, padding_bias


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 8
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407


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

# (text, vision) presets of the reference's checkpoints
CLIP_VIT_B32 = (CLIPTextConfig(), CLIPVisionConfig(patch_size=32))
CLIP_VIT_B16 = (CLIPTextConfig(), CLIPVisionConfig(patch_size=16))
CLIP_VIT_L14 = (CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                               num_layers=12, num_heads=12),
                CLIP_VIT_L14_VISION)


_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
# jax.checkpoint_policies names -> the ATen ops whose outputs the
# backward keeps (None: every op's); the rest of a block is recomputed.
# A Dense on a (N, L, D) input reaches mm/addmm, the attention products
# bmm (torch.matmul of 4-D tensors), as JAX's dots without / with batch
# dimensions
REMAT_POLICIES: Dict[str, Optional[Tuple[Any, ...]]] = {
    "nothing_saveable": (),
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
    "dots_saveable": _NO_BATCH_DOTS + _BATCH_DOTS,
    "checkpoint_dots": _NO_BATCH_DOTS + _BATCH_DOTS,
    "everything_saveable": None,
}
# jax.checkpoint_policies entries that build a policy from arguments
# (names of saved values, a second policy, an offload target)
POLICY_FACTORIES = ("save_only_these_names", "save_any_names_but_these",
                    "save_anything_except_these_names",
                    "save_and_offload_only_these_names",
                    "save_from_both_policies",
                    "offload_dot_with_no_batch_dims")


def remat_context_fn(policy: Optional[str]) -> Optional[Callable]:
    """``context_fn`` for ``torch.utils.checkpoint`` that saves what the
    named ``jax.checkpoint_policies`` policy saves (selective activation
    checkpointing); None (full recompute) for no name.  A policy
    factory's name raises ``NotImplementedError``, an unknown name
    ``AttributeError``, as ``getattr(jax.checkpoint_policies, name)``."""
    if not policy:
        return None
    if policy in POLICY_FACTORIES:
        raise NotImplementedError(
            f"remat_policy {policy!r} is a policy factory (it takes "
            f"arguments); the port takes the named policies "
            f"{sorted(REMAT_POLICIES)}")
    if policy not in REMAT_POLICIES:
        raise AttributeError(
            f"unknown remat_policy {policy!r}; known: "
            f"{sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        keep = saved is None or op in saved
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return partial(create_selective_checkpoint_contexts, policy_fn)


class CLIPTextEncoder(nn.Module):
    """HF ``CLIPTextModel``; ``with_projection`` adds the bias-free
    ``text_projection`` to ``projection_dim`` (HF
    ``CLIPTextModelWithProjection``).  Weights are drawn from
    ``generator`` (default: seeded with 0)."""

    def __init__(self, config: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32,
                 with_projection: bool = False, projection_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.token_embedding = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embedding = Embed(c.max_position_embeddings,
                                        c.hidden_size, dtype)
        self.num_layers = c.num_layers
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", PreLNBlock(
                c.hidden_size, c.num_heads, c.intermediate_size,
                c.hidden_act, c.layer_norm_eps, dtype))
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                          dtype)
        self.text_projection = (
            Dense(c.hidden_size, projection_dim, use_bias=False, dtype=dtype)
            if with_projection else None)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids/attention_mask (B, L).  Returns (last_hidden_state
        (B, L, D), pooled (B, D), projected when ``with_projection``).  A
        text longer than ``max_position_embeddings`` raises."""
        b, l = input_ids.shape
        if l > self.config.max_position_embeddings:
            raise ValueError(
                f"text length {l} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings}; lower "
                f"--max_txt_len")
        dev = input_ids.device
        pos = torch.arange(l, device=dev)
        x = self.token_embedding(input_ids) + self.position_embedding(
            pos[None, :])
        bias = causal_bias(l, dtype=self.dtype, device=dev)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask, dtype=self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, bias=bias)
        x = self.final_layer_norm(x)
        # the first EOS token of each row; a row with none pools its last
        # position
        is_eos = input_ids == self.config.eos_token_id
        eos_pos = torch.where(is_eos, pos, l).amin(dim=-1).clamp(max=l - 1)
        pooled = x[torch.arange(b, device=dev), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return x, pooled


class CLIPVisionEncoder(nn.Module):
    """``post_ln_all_tokens``: GIT post-LNs every token, plain CLIP only
    the CLS.  ``with_projection`` adds the bias-free visual projection.
    ``remat`` recomputes each block in the backward instead of keeping
    its activations (``torch.utils.checkpoint``, full recompute as
    ``nn.remat`` without a policy); ``remat_policy`` names a
    ``jax.checkpoint_policies`` policy whose saved values the backward
    keeps (:data:`REMAT_POLICIES`).  Weights are drawn from ``generator``
    (default: seeded with 0)."""

    def __init__(self, config: CLIPVisionConfig,
                 dtype: torch.dtype = torch.float32,
                 post_ln_all_tokens: bool = False,
                 with_projection: bool = True,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        c = config
        self.remat = remat
        self.remat_policy = remat_policy or None
        # as in the JAX package, the policy is read only under remat
        context_fn = remat_context_fn(remat_policy) if remat else None
        self._remat_kwargs = ({} if context_fn is None
                              else {"context_fn": context_fn})
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
            block = getattr(self, f"layers_{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False,
                               **self._remat_kwargs)
            else:
                x = block(x)
        if self.post_ln_all_tokens:
            x = self.post_layernorm(x)
            pooled = x[:, 0]
        else:
            pooled = self.post_layernorm(x[:, 0])
        image_embeds = None
        if self.visual_projection is not None:
            image_embeds = self.visual_projection(pooled)
        return x, pooled, image_embeds
