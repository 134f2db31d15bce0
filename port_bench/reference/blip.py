"""Plain BLIP VQA (``Salesforce/blip-vqa-*``) under SAS-VQA's answer
classifier, in float32, from a checkpoint in the published key names.

The towers follow ``transformers``' ``BlipForQuestionAnswering``
(modeling_blip.py, modeling_blip_text.py):

- the vision model is a BLIP ViT: a stride-``patch`` convolution with
  bias, a class token, a raw position table, pre-LN encoder layers
  (``layer_norm1``, fused ``qkv``, ``projection``, ``layer_norm2``, an
  erf-GELU MLP) and ``post_layernorm`` over every token; the pooled
  output is ``post_layernorm`` applied once more to the class token;
- the text encoder is word plus absolute position embeddings and a
  LayerNorm, then post-LN BERT layers: self-attention under the padding
  mask, cross-attention from the text into every frame token of the
  video (keys and values projected from the vision width into the text
  width), and the erf-GELU FFN.

SAS-VQA's head (the reference classifier's ``CrossAttentionLayer`` and
MLP classifier) reads the text encoder's hidden states: a zero token is
prepended, one dec-only post-LN decoder layer (8 heads, FFN 4 d, ReLU)
runs over [zero; text] with the frames' pooled embeddings as memory,
and position 0 goes through ``cls_fc``, tanh-GELU and ``classifier``.
The loss is the cross-entropy over rows whose answer has a label.

Checkpoint keys: ``vision_model.*``, ``text_encoder.*`` and one tensor
of ``text_decoder.*`` as published (the classifier does not use the
answer decoder, so the rest of it is not written); the head under the
reference
classifier's names: ``attention.attention.layers.{i}.*`` as a torch
``TransformerDecoderLayer`` holds them (its cross-attention's keys are
the vision width, so torch keeps ``q_proj_weight``, ``k_proj_weight``
and ``v_proj_weight`` apart beside one ``in_proj_bias``), ``cls_fc.*``
and ``classifier.*``.

Departures from ``transformers``' BLIP, as in the system under test:

- no answer decoder: the classifier head above answers, as SAS-VQA's
  BLIP classifier does;
- the text encoder's first token stays [CLS] (the original BLIP code
  swaps in [ENC]; ``transformers`` does not either);
- the head's LayerNorm epsilon is 1e-6 (flax's default, which the system
  uses), not torch's 1e-5.

Dropout in training follows the system's draw rule: one
``torch.Generator`` a micro-batch, on the inputs' device, seeded from
(run seed, micro step) by ``common.fold_in``.  The towers draw nothing
(BLIP's text dropouts are 0); the head draws, at the head's rate, the
masks after its self-attention, after its cross-attention, after its
ReLU and after its second FFN product, each over every position of
[zero; text], in that order.

Matrix products go through ``common.Arith``.  For the control,
``Float8Products`` computes in float8 (e4m3, one scale a tensor) where
the system computes in the bfloat16 the configurations state, in both
passes: both operands of every product (then an f32 product), and the
hidden states held between sublayers.  With
gradients on, each vision layer is recomputed in the backward
(``torch.utils.checkpoint``: the same products again), so that a
micro's f32 activations fit the card.

Nothing here imports the system under test.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.common import Arith, fake_fp8
from port_bench.reference.git import (dropout, heads, layer_norm, merge,
                                      tokens_per_frame)

NEG = float("-inf")
VIS = "vision_model"
TXT = "text_encoder"
DEC = "text_decoder"
FUSION = "attention.attention.layers"


def _bert_layer_shapes(s, p, d, ff, kv):
    for att, width in (("attention", d), ("crossattention", kv)):
        for proj, w in (("query", d), ("key", width), ("value", width)):
            s[f"{p}.{att}.self.{proj}.weight"] = (d, w)
            s[f"{p}.{att}.self.{proj}.bias"] = (d,)
        s[f"{p}.{att}.output.dense.weight"] = (d, d)
        s[f"{p}.{att}.output.dense.bias"] = (d,)
        s[f"{p}.{att}.output.LayerNorm.weight"] = (d,)
        s[f"{p}.{att}.output.LayerNorm.bias"] = (d,)
    s[f"{p}.intermediate.dense.weight"] = (ff, d)
    s[f"{p}.intermediate.dense.bias"] = (ff,)
    s[f"{p}.output.dense.weight"] = (d, ff)
    s[f"{p}.output.dense.bias"] = (d,)
    s[f"{p}.output.LayerNorm.weight"] = (d,)
    s[f"{p}.output.LayerNorm.bias"] = (d,)


def _bert_shapes(s, prefix, t, kv):
    d = t["hidden_size"]
    s[f"{prefix}.embeddings.word_embeddings.weight"] = (t["vocab_size"], d)
    s[f"{prefix}.embeddings.position_embeddings.weight"] = (
        t["max_position_embeddings"], d)
    s[f"{prefix}.embeddings.LayerNorm.weight"] = (d,)
    s[f"{prefix}.embeddings.LayerNorm.bias"] = (d,)
    for i in range(t["num_hidden_layers"]):
        _bert_layer_shapes(s, f"{prefix}.encoder.layer.{i}", d,
                           t["intermediate_size"], kv)


def checkpoint_shapes(c: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Key names and shapes of the published ``BlipForQuestionAnswering``
    state dict (of its answer decoder one tensor), then the answer
    head's (``c["answer_head"]``)."""
    v, t, h = c["vision_config"], c["text_config"], c["answer_head"]
    dv, ffv, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    s: Dict[str, Tuple[int, ...]] = {
        f"{VIS}.embeddings.class_embedding": (1, 1, dv),
        f"{VIS}.embeddings.position_embedding": (1, tokens_per_frame(c),
                                                 dv),
        f"{VIS}.embeddings.patch_embedding.weight": (dv, v["num_channels"],
                                                     p, p),
        f"{VIS}.embeddings.patch_embedding.bias": (dv,)}
    for i in range(v["num_hidden_layers"]):
        lp = f"{VIS}.encoder.layers.{i}"
        s[f"{lp}.self_attn.qkv.weight"] = (3 * dv, dv)
        s[f"{lp}.self_attn.qkv.bias"] = (3 * dv,)
        s[f"{lp}.self_attn.projection.weight"] = (dv, dv)
        s[f"{lp}.self_attn.projection.bias"] = (dv,)
        s[f"{lp}.layer_norm1.weight"] = (dv,)
        s[f"{lp}.layer_norm1.bias"] = (dv,)
        s[f"{lp}.mlp.fc1.weight"] = (ffv, dv)
        s[f"{lp}.mlp.fc1.bias"] = (ffv,)
        s[f"{lp}.mlp.fc2.weight"] = (dv, ffv)
        s[f"{lp}.mlp.fc2.bias"] = (dv,)
        s[f"{lp}.layer_norm2.weight"] = (dv,)
        s[f"{lp}.layer_norm2.bias"] = (dv,)
    s[f"{VIS}.post_layernorm.weight"] = (dv,)
    s[f"{VIS}.post_layernorm.bias"] = (dv,)
    _bert_shapes(s, TXT, t, dv)
    # one tensor of the answer decoder, which no side reads: the loader
    # still meets (and skips) the published layout's third part
    s[f"{DEC}.cls.predictions.bias"] = (t["vocab_size"],)
    d = t["hidden_size"]
    ff = h["ffn_scale"] * d
    for i in range(h["fusion_layers"]):
        lp = f"{FUSION}.{i}"
        s[f"{lp}.self_attn.in_proj_weight"] = (3 * d, d)
        s[f"{lp}.self_attn.in_proj_bias"] = (3 * d,)
        s[f"{lp}.self_attn.out_proj.weight"] = (d, d)
        s[f"{lp}.self_attn.out_proj.bias"] = (d,)
        s[f"{lp}.multihead_attn.q_proj_weight"] = (d, d)
        s[f"{lp}.multihead_attn.k_proj_weight"] = (d, dv)
        s[f"{lp}.multihead_attn.v_proj_weight"] = (d, dv)
        s[f"{lp}.multihead_attn.in_proj_bias"] = (3 * d,)
        s[f"{lp}.multihead_attn.out_proj.weight"] = (d, d)
        s[f"{lp}.multihead_attn.out_proj.bias"] = (d,)
        s[f"{lp}.linear1.weight"] = (ff, d)
        s[f"{lp}.linear1.bias"] = (ff,)
        s[f"{lp}.linear2.weight"] = (d, ff)
        s[f"{lp}.linear2.bias"] = (d,)
        for n in ("norm1", "norm2", "norm3"):
            s[f"{lp}.{n}.weight"] = (d,)
            s[f"{lp}.{n}.bias"] = (d,)
    width = d
    if h["classifier"] == "mlp":
        width = h["cls_hidden_scale"] * d
        s["cls_fc.weight"] = (width, d)
        s["cls_fc.bias"] = (width,)
    s["classifier.weight"] = (h["num_labels"], width)
    s["classifier.bias"] = (h["num_labels"],)
    return s


def is_layer_norm_weight(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and (
        any(k in parts[-2].lower() for k in ("layernorm", "layer_norm"))
        or parts[-2] in ("norm1", "norm2", "norm3"))


def trainable(name: str) -> bool:
    """Every leaf the classifier reads: all but the answer decoder."""
    return not name.startswith(f"{DEC}.")


# ---- the control's arithmetic ----------------------------------------------

class _RoundGradient(torch.autograd.Function):
    """The identity, whose gradient is rounded to float8: the operand a
    product's output gradient is in the backward's two products."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return fake_fp8(g)


class Float8Products(Arith):
    """Float8 where the system computes in bf16: every matrix product's
    operands, and the hidden states held between sublayers (the
    residual streams' sums and the LayerNorms' outputs), in both passes.
    ``Arith(True)`` rounds the forward's operands and passes gradients
    through, which leaves the backward in f32; here each product's
    output gradient and each held state's gradient is rounded too."""

    def __init__(self):
        super().__init__(True)

    def hold(self, x):
        return _RoundGradient.apply(fake_fp8(x))

    def linear(self, x, w, b=None):
        return _RoundGradient.apply(super().linear(x, w, b))

    def matmul(self, a, b):
        return _RoundGradient.apply(super().matmul(a, b))


# ---- the model ------------------------------------------------------------

def _hold(ar: Arith, x: torch.Tensor) -> torch.Tensor:
    """A hidden state as the arithmetic keeps it between sublayers: as
    it is in f32, rounded in both passes under ``Float8Products``."""
    return ar.hold(x) if isinstance(ar, Float8Products) else x


def _vision_layer(W, lp, h, nh, eps, ar: Arith):
    a = layer_norm(h, W[f"{lp}.layer_norm1.weight"],
                   W[f"{lp}.layer_norm1.bias"], eps)
    q, k, v = (heads(x, nh) for x in ar.linear(
        a, W[f"{lp}.self_attn.qkv.weight"],
        W[f"{lp}.self_attn.qkv.bias"]).chunk(3, dim=-1))
    s = ar.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    ctx = merge(ar.matmul(torch.softmax(s, dim=-1), v))
    h = _hold(ar, h + ar.linear(ctx, W[f"{lp}.self_attn.projection.weight"],
                                W[f"{lp}.self_attn.projection.bias"]))
    a = layer_norm(h, W[f"{lp}.layer_norm2.weight"],
                   W[f"{lp}.layer_norm2.bias"], eps)
    a = F.gelu(ar.linear(a, W[f"{lp}.mlp.fc1.weight"],
                       W[f"{lp}.mlp.fc1.bias"]))
    return _hold(ar, h + ar.linear(a, W[f"{lp}.mlp.fc2.weight"],
                                   W[f"{lp}.mlp.fc2.bias"]))


def vision(W: Mapping[str, torch.Tensor], c: Mapping, pixels: torch.Tensor,
           ar: Arith) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, H, W) f32 pixels -> (every token after ``post_layernorm``
    (N, P, Dv), the pooled class token (N, Dv))."""
    v = c["vision_config"]
    p = v["patch_size"]
    n, ch, hh, ww = pixels.shape
    # the stride-p convolution as a product over unfolded patches
    patches = pixels.reshape(n, ch, hh // p, p, ww // p, p).permute(
        0, 2, 4, 1, 3, 5).reshape(n, (hh // p) * (ww // p), ch * p * p)
    pw = W[f"{VIS}.embeddings.patch_embedding.weight"]
    emb = ar.linear(patches, pw.reshape(pw.shape[0], -1),
                    W[f"{VIS}.embeddings.patch_embedding.bias"])
    cls = W[f"{VIS}.embeddings.class_embedding"].expand(n, 1, -1)
    h = _hold(ar, torch.cat([cls, emb], dim=1)
              + W[f"{VIS}.embeddings.position_embedding"])
    eps, nh = v["layer_norm_eps"], v["num_attention_heads"]
    for i in range(v["num_hidden_layers"]):
        lp = f"{VIS}.encoder.layers.{i}"
        if torch.is_grad_enabled():
            h = checkpoint(_vision_layer, W, lp, h, nh, eps, ar,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _vision_layer(W, lp, h, nh, eps, ar)
    ln = (W[f"{VIS}.post_layernorm.weight"], W[f"{VIS}.post_layernorm.bias"])
    h = _hold(ar, layer_norm(h, *ln, eps))
    return h, _hold(ar, layer_norm(h[:, 0], *ln, eps))


def _bert_attention(W, p, x, kv, add, nh, eps, ar: Arith):
    q = heads(ar.linear(x, W[f"{p}.self.query.weight"],
                        W[f"{p}.self.query.bias"]), nh)
    k, v = (heads(ar.linear(kv, W[f"{p}.self.{n}.weight"],
                            W[f"{p}.self.{n}.bias"]), nh)
            for n in ("key", "value"))
    s = ar.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if add is not None:
        s = s + add
    ctx = merge(ar.matmul(torch.softmax(s, dim=-1), v))
    o = ar.linear(ctx, W[f"{p}.output.dense.weight"],
                  W[f"{p}.output.dense.bias"])
    return _hold(ar, layer_norm(_hold(ar, x + o),
                                W[f"{p}.output.LayerNorm.weight"],
                                W[f"{p}.output.LayerNorm.bias"], eps))


def key_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) 1/0 -> the additive (B, 1, 1, L) mask of padded keys."""
    zero = torch.zeros((), device=mask.device)
    return torch.where(mask != 0, zero, zero + NEG)[:, None, None, :]


def text_encoder(W, c, input_ids, attention_mask, frames_hidden,
                 ar: Arith) -> torch.Tensor:
    """(B, L) ids and mask, (B, M, Dv) frame tokens -> (B, L, D)."""
    t = c["text_config"]
    eps, nh = t["layer_norm_eps"], t["num_attention_heads"]
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    e = W[f"{TXT}.embeddings.word_embeddings.weight"][input_ids] \
        + W[f"{TXT}.embeddings.position_embeddings.weight"][pos][None]
    h = _hold(ar, layer_norm(_hold(ar, e),
                             W[f"{TXT}.embeddings.LayerNorm.weight"],
                             W[f"{TXT}.embeddings.LayerNorm.bias"], eps))
    add = key_mask(attention_mask)
    for i in range(t["num_hidden_layers"]):
        lp = f"{TXT}.encoder.layer.{i}"
        h = _bert_attention(W, f"{lp}.attention", h, h, add, nh, eps, ar)
        h = _bert_attention(W, f"{lp}.crossattention", h, frames_hidden,
                            None, nh, eps, ar)
        a = F.gelu(ar.linear(h, W[f"{lp}.intermediate.dense.weight"],
                           W[f"{lp}.intermediate.dense.bias"]))
        o = ar.linear(a, W[f"{lp}.output.dense.weight"],
                      W[f"{lp}.output.dense.bias"])
        h = _hold(ar, layer_norm(_hold(ar, h + o),
                                 W[f"{lp}.output.LayerNorm.weight"],
                                 W[f"{lp}.output.LayerNorm.bias"], eps))
    return h


def _torch_mha(W, p, x, mem, add, nh, ar: Arith):
    """torch ``MultiheadAttention`` of queries ``x`` over ``mem``."""
    b = W[f"{p}.in_proj_bias"].chunk(3)
    if f"{p}.in_proj_weight" in W:
        w = W[f"{p}.in_proj_weight"].chunk(3)
    else:
        w = tuple(W[f"{p}.{n}_proj_weight"] for n in "qkv")
    q = heads(ar.linear(x, w[0], b[0]), nh)
    k, v = (heads(ar.linear(mem, w[i], b[i]), nh) for i in (1, 2))
    s = ar.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if add is not None:
        s = s + add
    ctx = merge(ar.matmul(torch.softmax(s, dim=-1), v))
    return ar.linear(ctx, W[f"{p}.out_proj.weight"], W[f"{p}.out_proj.bias"])


def head(W, c, txt, attention_mask, pooled, gen, ar: Arith) -> torch.Tensor:
    """Text hidden states (B, L, D) and mask, the frames' pooled
    embeddings (B, T, Dv) -> f32 logits (B, num_labels); ``gen`` turns the
    dropouts on."""
    h = c["answer_head"]
    rate = h["hidden_dropout_prob"] if gen is not None else 0.0
    eps, nh = h["layer_norm_eps"], h["fusion_heads"]
    b, _, d = txt.shape
    x = torch.cat([txt.new_zeros((b, 1, d)), txt], dim=1)
    add = key_mask(torch.cat([attention_mask.new_ones((b, 1)),
                              attention_mask], dim=1))
    for i in range(h["fusion_layers"]):
        lp = f"{FUSION}.{i}"

        def ln(y, n):
            return _hold(ar, layer_norm(_hold(ar, y), W[f"{lp}.{n}.weight"],
                                        W[f"{lp}.{n}.bias"], eps))

        x = ln(x + dropout(_torch_mha(W, f"{lp}.self_attn", x, x, add, nh,
                                      ar), rate, gen), "norm1")
        x = ln(x + dropout(_torch_mha(W, f"{lp}.multihead_attn", x, pooled,
                                      None, nh, ar), rate, gen), "norm2")
        a = dropout(F.relu(ar.linear(x, W[f"{lp}.linear1.weight"],
                                     W[f"{lp}.linear1.bias"])), rate, gen)
        x = ln(x + dropout(ar.linear(a, W[f"{lp}.linear2.weight"],
                                     W[f"{lp}.linear2.bias"]), rate, gen),
               "norm3")
    pooled0 = x[:, 0]
    if h["classifier"] == "mlp":
        pooled0 = F.gelu(ar.linear(pooled0, W["cls_fc.weight"],
                                   W["cls_fc.bias"]), approximate="tanh")
    return ar.linear(pooled0, W["classifier.weight"], W["classifier.bias"])


def logits(W, c, pixels, input_ids, attention_mask,
           gen: Optional[torch.Generator], ar: Arith) -> torch.Tensor:
    """(B, T, C, H, W) pixels, one video a row, and the questions ->
    answer logits (B, num_labels)."""
    b, t = pixels.shape[:2]
    hidden, pooled = vision(W, c, pixels.reshape(
        (b * t,) + tuple(pixels.shape[2:])), ar)
    frames_hidden = hidden.reshape(b, t * hidden.shape[1], hidden.shape[2])
    txt = text_encoder(W, c, input_ids, attention_mask, frames_hidden, ar)
    return head(W, c, txt, attention_mask, pooled.reshape(b, t, -1), gen,
                ar)


def train_loss(W, c, pixels, input_ids, attention_mask, labels,
               gen: Optional[torch.Generator], ar: Arith) -> torch.Tensor:
    """The cross-entropy of one micro-batch over rows whose label is not
    -100, dropouts on when ``gen`` is given."""
    z = logits(W, c, pixels, input_ids, attention_mask, gen, ar)
    valid = labels != -100
    nll = F.cross_entropy(z, torch.where(valid, labels, 0),
                          reduction="none")
    return (nll * valid).sum() / valid.sum().clamp(min=1)
