"""Plain GIT (GenerativeImage2Text) in float32, from a checkpoint in
Hugging Face's ``GitForCausalLM`` key names.

It follows the published architecture (``transformers``' modeling_git):

- the image encoder is a CLIP vision transformer: a stride-``patch``
  convolution without bias, a class token, position embeddings,
  ``pre_layrnorm``, pre-LN encoder layers (quick-GELU MLP) and
  ``post_layernorm`` over every token;
- each frame's tokens go through ``visual_projection`` (a linear layer
  and a LayerNorm), and the frames of a video are concatenated into one
  visual prefix of ``frames * tokens_per_frame`` tokens;
- the text embeddings are word plus absolute position embeddings, a
  LayerNorm and dropout;
- six post-LN BERT layers run over [visual prefix; text] under GIT's
  mask: image rows see image columns only, text rows see every image
  column and the causal, unpadded text columns;
- the LM head reads the text positions, and the loss is the shifted
  cross-entropy over labels other than -100.

Departure, as in the system under test: the checkpoint's
``img_temporal_embedding`` (one vector a frame) is not added.

Dropout in training follows the system's draw rule: one
``torch.Generator`` a micro-batch, on the inputs' device, seeded from
(run seed, micro step) by ``common.fold_in``; it draws the embedding
mask, then for each text layer a 32-bit attention seed, the
attention-output mask and the FFN-output mask, in that order.  The attention-probability
mask is the published coordinate hash of :mod:`.hashdrop`.

Matrix products go through ``common.Arith``, which for the control
rounds both operands to float8 (e4m3, one scale a tensor) before an f32
product: a precision below the bfloat16 the configurations state.

Nothing here imports the system under test.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import hashdrop
from port_bench.reference.common import Arith

NEG = float("-inf")
def tokens_per_frame(c: Mapping) -> int:
    v = c["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def hf_git_shapes(c: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Key names and shapes of ``GitForCausalLM``'s state dict."""
    d, ff = c["hidden_size"], c["intermediate_size"]
    v = c["vision_config"]
    dv, ffv, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    s = {"git.embeddings.word_embeddings.weight": (c["vocab_size"], d),
         "git.embeddings.position_embeddings.weight":
             (c["max_position_embeddings"], d),
         "git.embeddings.LayerNorm.weight": (d,),
         "git.embeddings.LayerNorm.bias": (d,)}
    vp = "git.image_encoder.vision_model"
    s[f"{vp}.embeddings.class_embedding"] = (dv,)
    s[f"{vp}.embeddings.patch_embedding.weight"] = (dv, v["num_channels"],
                                                    p, p)
    s[f"{vp}.embeddings.position_embedding.weight"] = (tokens_per_frame(c),
                                                       dv)
    for ln in ("pre_layrnorm", "post_layernorm"):
        s[f"{vp}.{ln}.weight"] = (dv,)
        s[f"{vp}.{ln}.bias"] = (dv,)
    for i in range(v["num_hidden_layers"]):
        lp = f"{vp}.encoder.layers.{i}"
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            s[f"{lp}.self_attn.{proj}.weight"] = (dv, dv)
            s[f"{lp}.self_attn.{proj}.bias"] = (dv,)
        for ln in ("layer_norm1", "layer_norm2"):
            s[f"{lp}.{ln}.weight"] = (dv,)
            s[f"{lp}.{ln}.bias"] = (dv,)
        s[f"{lp}.mlp.fc1.weight"] = (ffv, dv)
        s[f"{lp}.mlp.fc1.bias"] = (ffv,)
        s[f"{lp}.mlp.fc2.weight"] = (dv, ffv)
        s[f"{lp}.mlp.fc2.bias"] = (dv,)
    for i in range(c["num_hidden_layers"]):
        lp = f"git.encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            s[f"{lp}.{name}.weight"] = (d, d)
            s[f"{lp}.{name}.bias"] = (d,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            s[f"{lp}.{ln}.weight"] = (d,)
            s[f"{lp}.{ln}.bias"] = (d,)
        s[f"{lp}.intermediate.dense.weight"] = (ff, d)
        s[f"{lp}.intermediate.dense.bias"] = (ff,)
        s[f"{lp}.output.dense.weight"] = (d, ff)
        s[f"{lp}.output.dense.bias"] = (d,)
    pj = "git.visual_projection.visual_projection"
    s[f"{pj}.0.weight"] = (d, dv)
    s[f"{pj}.0.bias"] = (d,)
    s[f"{pj}.1.weight"] = (d,)
    s[f"{pj}.1.bias"] = (d,)
    for i in range(c.get("num_image_with_embedding") or 0):
        s[f"git.img_temporal_embedding.{i}"] = (1, 1, d)
    s["output.weight"] = (c["vocab_size"], d)
    s["output.bias"] = (c["vocab_size"],)
    return s


def is_layer_norm_weight(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and any(
        k in parts[-2].lower() for k in ("layernorm", "layer_norm",
                                         "layrnorm")) \
        or name.endswith("visual_projection.1.weight")


def trainable(name: str) -> bool:
    """Leaves the model trains: all but the temporal embeddings, which
    the system does not use."""
    return "img_temporal_embedding" not in name


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def dropout(x, rate, gen):
    """The system's draw: f32 uniforms of ``x``'s shape from ``gen``."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def heads(x, n):
    b, l, d = x.shape
    return x.view(b, l, n, d // n).transpose(1, 2)


def merge(x):
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


# ---- the model ------------------------------------------------------------

def encode_frames(W: Mapping[str, torch.Tensor], c: Mapping,
                  pixels: torch.Tensor, ar: Arith) -> torch.Tensor:
    """(B, T, C, H, W) f32 pixels -> the projected visual prefix
    (B, T * tokens_per_frame, hidden)."""
    v = c["vision_config"]
    vp = "git.image_encoder.vision_model"
    b, t = pixels.shape[:2]
    x = pixels.reshape((b * t,) + tuple(pixels.shape[2:]))
    pw = W[f"{vp}.embeddings.patch_embedding.weight"]
    p = v["patch_size"]
    n, ch, hh, ww = x.shape
    # the stride-p convolution as a product over unfolded patches
    patches = x.reshape(n, ch, hh // p, p, ww // p, p).permute(
        0, 2, 4, 1, 3, 5).reshape(n, (hh // p) * (ww // p), ch * p * p)
    emb = ar.linear(patches, pw.reshape(pw.shape[0], -1))
    cls = W[f"{vp}.embeddings.class_embedding"].expand(n, 1, -1)
    h = torch.cat([cls, emb], dim=1) \
        + W[f"{vp}.embeddings.position_embedding.weight"][None]
    eps = v["layer_norm_eps"]
    h = layer_norm(h, W[f"{vp}.pre_layrnorm.weight"],
                   W[f"{vp}.pre_layrnorm.bias"], eps)
    nh = v["num_attention_heads"]
    for i in range(v["num_hidden_layers"]):
        lp = f"{vp}.encoder.layers.{i}"
        a = layer_norm(h, W[f"{lp}.layer_norm1.weight"],
                       W[f"{lp}.layer_norm1.bias"], eps)
        q, k, vv = (heads(ar.linear(a, W[f"{lp}.self_attn.{n_}.weight"],
                                    W[f"{lp}.self_attn.{n_}.bias"]), nh)
                    for n_ in ("q_proj", "k_proj", "v_proj"))
        s = ar.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        ctx = merge(ar.matmul(torch.softmax(s, dim=-1), vv))
        h = h + ar.linear(ctx, W[f"{lp}.self_attn.out_proj.weight"],
                          W[f"{lp}.self_attn.out_proj.bias"])
        a = layer_norm(h, W[f"{lp}.layer_norm2.weight"],
                       W[f"{lp}.layer_norm2.bias"], eps)
        a = quick_gelu(ar.linear(a, W[f"{lp}.mlp.fc1.weight"],
                                 W[f"{lp}.mlp.fc1.bias"]))
        h = h + ar.linear(a, W[f"{lp}.mlp.fc2.weight"],
                          W[f"{lp}.mlp.fc2.bias"])
    h = layer_norm(h, W[f"{vp}.post_layernorm.weight"],
                   W[f"{vp}.post_layernorm.bias"], eps)
    h = h.reshape(b, t * h.shape[1], h.shape[2])
    pj = "git.visual_projection.visual_projection"
    h = ar.linear(h, W[f"{pj}.0.weight"], W[f"{pj}.0.bias"])
    return layer_norm(h, W[f"{pj}.1.weight"], W[f"{pj}.1.bias"], eps)


def git_mask(num_img: int, attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, S, S) bool: may row r attend column c."""
    b, l = attention_mask.shape
    s = num_img + l
    idx = torch.arange(s, device=attention_mask.device)
    rows, cols = idx[:, None], idx[None, :]
    img_col = cols < num_img
    valid_col = torch.cat([torch.ones((b, num_img), dtype=torch.bool,
                                      device=attention_mask.device),
                           attention_mask != 0], dim=1)[:, None, :]
    text_row = img_col | ((cols <= rows) & valid_col)
    return torch.where(rows >= num_img, text_row, img_col)[:, None]


def text_stack(W, c, vis, input_ids, attention_mask, ar: Arith,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The hidden states of [visual prefix; text] after the text layers
    (B, M + L, hidden).  ``gen`` turns the dropouts on."""
    b, l = input_ids.shape
    m = vis.shape[1]
    rate = c["hidden_dropout_prob"] if gen is not None else 0.0
    attn_rate = c["attention_probs_dropout_prob"] if gen is not None \
        else 0.0
    eps = c["layer_norm_eps"]
    pos = torch.arange(l, device=input_ids.device)
    e = W["git.embeddings.word_embeddings.weight"][input_ids] \
        + W["git.embeddings.position_embeddings.weight"][pos][None]
    e = layer_norm(e, W["git.embeddings.LayerNorm.weight"],
                   W["git.embeddings.LayerNorm.bias"], eps)
    h = torch.cat([vis, dropout(e, rate, gen)], dim=1)
    ok = git_mask(m, attention_mask)
    zero = torch.zeros((), device=h.device)
    add = torch.where(ok, zero, zero + NEG)
    nh = c["num_attention_heads"]
    for i in range(c["num_hidden_layers"]):
        lp = f"git.encoder.layer.{i}"
        seed = None
        if attn_rate > 0.0:
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), generator=gen,
                                 device=h.device, dtype=torch.int64)
        q, k, v = (heads(ar.linear(h, W[f"{lp}.attention.self.{n_}.weight"],
                                   W[f"{lp}.attention.self.{n_}.bias"]), nh)
                   for n_ in ("query", "key", "value"))
        s = ar.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5 + add
        p = torch.softmax(s, dim=-1)
        if seed is not None:
            p = p * hashdrop.factor(b, nh, h.shape[1], seed, attn_rate)
        ctx = merge(ar.matmul(p, v))
        o = ar.linear(ctx, W[f"{lp}.attention.output.dense.weight"],
                      W[f"{lp}.attention.output.dense.bias"])
        h = layer_norm(h + dropout(o, rate, gen),
                       W[f"{lp}.attention.output.LayerNorm.weight"],
                       W[f"{lp}.attention.output.LayerNorm.bias"], eps)
        a = F.gelu(ar.linear(h, W[f"{lp}.intermediate.dense.weight"],
                             W[f"{lp}.intermediate.dense.bias"]))
        o = ar.linear(a, W[f"{lp}.output.dense.weight"],
                      W[f"{lp}.output.dense.bias"])
        h = layer_norm(h + dropout(o, rate, gen),
                       W[f"{lp}.output.LayerNorm.weight"],
                       W[f"{lp}.output.LayerNorm.bias"], eps)
    return h


def train_loss(W, c, pixels, input_ids, attention_mask, labels,
               gen: Optional[torch.Generator], ar: Arith) -> torch.Tensor:
    """The shifted cross-entropy of one micro-batch, dropouts on when
    ``gen`` is given."""
    vis = encode_frames(W, c, pixels, ar)
    h = text_stack(W, c, vis, input_ids, attention_mask, ar, gen)
    m = vis.shape[1]
    logits = ar.linear(h[:, m:-1], W["output.weight"], W["output.bias"])
    tgt = labels[:, 1:]
    valid = tgt != -100
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          torch.where(valid, tgt, 0).reshape(-1),
                          reduction="none").reshape(tgt.shape)
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def next_token_logits(W, c, pixels, input_ids, attention_mask,
                      ar: Arith) -> torch.Tensor:
    """Logits (B, L, vocab) of the token after each text position, in
    the eval forward (no dropout)."""
    vis = encode_frames(W, c, pixels, ar)
    h = text_stack(W, c, vis, input_ids, attention_mask, ar)
    return ar.linear(h[:, vis.shape[1]:], W["output.weight"],
                     W["output.bias"])
