"""Where each leaf of the program's GIT lives in the published
checkpoint: a name map from ``GITForCausalLM.named_parameters()`` to
``GitForCausalLM``'s state-dict keys.  A fused QKV leaf holds the query,
key and value leaves stacked in that order on its output axis; the
patch embedding holds the convolution's kernel unfolded (same
elements, so the same norm)."""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

VIS = "git.image_encoder.vision_model"

_RULES: List[Tuple[str, str]] = [
    (r"image_encoder\.class_embedding", f"{VIS}.embeddings.class_embedding"),
    (r"image_encoder\.patch_embedding\.proj\.weight",
     f"{VIS}.embeddings.patch_embedding.weight"),
    (r"image_encoder\.position_embedding\.weight",
     f"{VIS}.embeddings.position_embedding.weight"),
    (r"image_encoder\.(pre_layrnorm|post_layernorm)\.(weight|bias)",
     VIS + r".\1.\2"),
    (r"image_encoder\.layers_(\d+)\.(layer_norm1|layer_norm2|mlp\.fc1|"
     r"mlp\.fc2|self_attn\.out_proj)\.(weight|bias)",
     VIS + r".encoder.layers.\1.\2.\3"),
    (r"image_encoder\.layers_(\d+)\.self_attn\.qkv\.(weight|bias)",
     VIS + r".encoder.layers.\1.self_attn.{q_proj,k_proj,v_proj}.\2"),
    (r"visual_projection\.(weight|bias)",
     r"git.visual_projection.visual_projection.0.\1"),
    (r"visual_projection_ln\.(weight|bias)",
     r"git.visual_projection.visual_projection.1.\1"),
    (r"word_embeddings\.weight", "git.embeddings.word_embeddings.weight"),
    (r"position_embeddings\.weight",
     "git.embeddings.position_embeddings.weight"),
    (r"emb_ln\.(weight|bias)", r"git.embeddings.LayerNorm.\1"),
    (r"layer_(\d+)\.attention\.qkv\.(weight|bias)",
     r"git.encoder.layer.\1.attention.self.{query,key,value}.\2"),
    (r"layer_(\d+)\.attention\.out_dense\.(weight|bias)",
     r"git.encoder.layer.\1.attention.output.dense.\2"),
    (r"layer_(\d+)\.attention\.out_ln\.(weight|bias)",
     r"git.encoder.layer.\1.attention.output.LayerNorm.\2"),
    (r"layer_(\d+)\.ffn\.intermediate\.(weight|bias)",
     r"git.encoder.layer.\1.intermediate.dense.\2"),
    (r"layer_(\d+)\.ffn\.output\.(weight|bias)",
     r"git.encoder.layer.\1.output.dense.\2"),
    (r"layer_(\d+)\.ffn\.ln\.(weight|bias)",
     r"git.encoder.layer.\1.output.LayerNorm.\2"),
    (r"output\.(weight|bias)", r"output.\1"),
]


def checkpoint_keys(name: str) -> List[str]:
    """The checkpoint keys a program leaf holds, in stacking order."""
    for pat, repl in _RULES:
        m = re.fullmatch(pat, name)
        if m:
            key = m.expand(repl)
            if "{" in key:
                head, rest = key.split("{", 1)
                parts, tail = rest.split("}", 1)
                return [head + p + tail for p in parts.split(",")]
            return [key]
    raise KeyError(f"no checkpoint key for program leaf {name!r}")


def leaf_norms(tensors: Mapping[str, torch.Tensor],
               names: Sequence[str]) -> Dict[str, float]:
    """Norms of program leaves, by checkpoint key (a fused leaf split
    into its parts)."""
    out = {}
    for n in names:
        keys = checkpoint_keys(n)
        parts = torch.chunk(tensors[n], len(keys), dim=0)
        for k, t in zip(keys, parts):
            out[k] = float(t.double().norm())
    return out
