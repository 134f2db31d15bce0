"""BLIP (``BlipForQuestionAnswering`` under SAS-VQA's answer classifier):
the family of ``configs/blip_large.json``.

- ``checkpoint_shapes``, ``is_layer_norm_weight``, ``trainable``: the
  published checkpoint with the answer head, as the benchmark writes it
  from the seed (:mod:`port_bench.reference.blip`);
- ``micro_loss``: the plain f32 reference's cross-entropy over
  annotation rows, each row's label read from the answer list the
  configuration's ``answer_head.ans2label`` names (the file the traffic's
  task config gives the program as ``ans2label_path``);
- ``leaf_norms``: norms of the program's leaves by checkpoint key;
- ``update_flops`` and ``profiled``: model FLOPs of an update, and the
  generic flash kernels' device seconds and least seconds in a profiled
  update (K5 ``flash_fwd_sm90``, K6 ``flash_bwd_dq_sm90`` and
  ``flash_bwd_dkv_sm90``, one each a vision layer a micro).

A classifier answers by label, so ``next_token_logits`` and ``prompt``
(the answer driver's) raise: no answer cell runs this family."""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench import flops, trace
from port_bench.reference import blip as ref
from port_bench.reference.blip import (checkpoint_shapes,  # noqa: F401
                                       is_layer_norm_weight, trainable)
from port_bench.reference.text import ids as text_ids

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- rows ------------------------------------------------------------------


def ans2label(c: Mapping) -> Dict[str, int]:
    with open(os.path.join(HERE, c["answer_head"]["ans2label"])) as f:
        return json.load(f)


def question_row(vocab: Dict[str, int], question: str, length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """[CLS] question [SEP], right-padded to ``length`` (the collator's
    ``max_txt_len``): (ids, mask).  A longer question is an error: the
    traffic's questions fit, and truncation is not reproduced here."""
    row = [vocab["[CLS]"]] + text_ids(vocab, question) + [vocab["[SEP]"]]
    if len(row) > length:
        raise ValueError(f"{question!r}: {len(row)} tokens > {length}")
    ids = np.full(length, vocab["[PAD]"], np.int64)
    ids[:len(row)] = row
    mask = np.zeros(length, np.int64)
    mask[:len(row)] = 1
    return ids, mask


def micro_loss(params: Mapping[str, torch.Tensor], c: Mapping,
               rows: List[Dict[str, Any]], pixels: torch.Tensor,
               vocab_map: Dict[str, int], text_len: int,
               gen: torch.Generator, ar) -> torch.Tensor:
    """The classification loss of one training micro-batch: ``rows`` its
    annotations, ``pixels`` (rows, frames, 3, H, W).  The questions are
    padded to the classifier's ``max_txt_len``, as the program's
    collator pads them (the head's dropout masks are drawn over that
    length); ``text_len`` (the GIT sequence length) is not used."""
    length = int(c["answer_head"]["max_txt_len"])
    table = ans2label(c)
    ids, mask = (torch.from_numpy(np.stack(x)).to(pixels.device)
                 for x in zip(*[question_row(vocab_map, a["question"],
                                             length) for a in rows]))
    labels = torch.tensor([table.get(a["answer"], -100) for a in rows],
                          dtype=torch.long, device=pixels.device)
    if ar.quant:    # the control: float8 where the program runs bf16
        ar = ref.Float8Products()
    return ref.train_loss(params, c, pixels, ids, mask, labels, gen, ar)


def next_token_logits(*args, **kwargs):
    raise NotImplementedError("a BLIP classifier answers by label: no "
                              "answer cell runs the blip family")


def prompt(*args, **kwargs):
    raise NotImplementedError("a BLIP classifier answers by label: no "
                              "answer cell runs the blip family")


# ---- where each program leaf lives in the checkpoint -----------------------

_V, _T, _F = ref.VIS, ref.TXT, ref.FUSION
_RULES: List[Tuple[str, Optional[str]]] = [
    (r"vis_model\.class_embedding", f"{_V}.embeddings.class_embedding"),
    (r"vis_model\.position_embedding", f"{_V}.embeddings.position_embedding"),
    (r"vis_model\.patch_embedding\.proj\.(weight|bias)",
     _V + r".embeddings.patch_embedding.\1"),
    (r"vis_model\.layers_(\d+)\.self_attn\.qkv\.(weight|bias)",
     _V + r".encoder.layers.\1.self_attn.qkv.\2"),
    (r"vis_model\.layers_(\d+)\.self_attn\.out_proj\.(weight|bias)",
     _V + r".encoder.layers.\1.self_attn.projection.\2"),
    (r"vis_model\.layers_(\d+)\.(layer_norm1|layer_norm2|mlp\.fc1|mlp\.fc2)"
     r"\.(weight|bias)", _V + r".encoder.layers.\1.\2.\3"),
    (r"vis_model\.post_layernorm\.(weight|bias)", _V + r".post_layernorm.\1"),
    (r"txt_model\.(word|position)_embeddings\.weight",
     _T + r".embeddings.\1_embeddings.weight"),
    (r"txt_model\.emb_ln\.(weight|bias)", _T + r".embeddings.LayerNorm.\1"),
    (r"txt_model\.layers_(\d+)\.(attention|crossattention)\."
     r"(query|key|value)\.(weight|bias)",
     _T + r".encoder.layer.\1.\2.self.\3.\4"),
    (r"txt_model\.layers_(\d+)\.(attention|crossattention)\.out_dense\."
     r"(weight|bias)", _T + r".encoder.layer.\1.\2.output.dense.\3"),
    (r"txt_model\.layers_(\d+)\.(attention|crossattention)\.out_ln\."
     r"(weight|bias)", _T + r".encoder.layer.\1.\2.output.LayerNorm.\3"),
    (r"txt_model\.layers_(\d+)\.ffn\.intermediate\.(weight|bias)",
     _T + r".encoder.layer.\1.intermediate.dense.\2"),
    (r"txt_model\.layers_(\d+)\.ffn\.output\.(weight|bias)",
     _T + r".encoder.layer.\1.output.dense.\2"),
    (r"txt_model\.layers_(\d+)\.ffn\.ln\.(weight|bias)",
     _T + r".encoder.layer.\1.output.LayerNorm.\2"),
    # BlipForQuestionAnswering's text encoder has no pooler, and the
    # classifier never reads the program's (its gradient is 0)
    (r"txt_model\.pooler\.(weight|bias)", None),
    # torch's MultiheadAttention packs the self-attention's q, k, v
    # weights, and both attentions' biases, on one output axis
    (r"answer_head\.attention\.layers_(\d+)\.self_attn\.[qkv]_proj\.weight",
     _F + r".\1.self_attn.in_proj_weight"),
    (r"answer_head\.attention\.layers_(\d+)\.self_attn\.[qkv]_proj\.bias",
     _F + r".\1.self_attn.in_proj_bias"),
    (r"answer_head\.attention\.layers_(\d+)\.cross_attn\.([qkv])_proj\."
     r"weight", _F + r".\1.multihead_attn.\2_proj_weight"),
    (r"answer_head\.attention\.layers_(\d+)\.cross_attn\.[qkv]_proj\.bias",
     _F + r".\1.multihead_attn.in_proj_bias"),
    (r"answer_head\.attention\.layers_(\d+)\.self_attn\.out_proj\."
     r"(weight|bias)", _F + r".\1.self_attn.out_proj.\2"),
    (r"answer_head\.attention\.layers_(\d+)\.cross_attn\.out_proj\."
     r"(weight|bias)", _F + r".\1.multihead_attn.out_proj.\2"),
    (r"answer_head\.attention\.layers_(\d+)\.(linear1|linear2|norm1|norm2|"
     r"norm3)\.(weight|bias)", _F + r".\1.\2.\3"),
    (r"answer_head\.(cls_fc|classifier)\.(weight|bias)", r"\1.\2"),
]


def checkpoint_key(name: str) -> Optional[str]:
    """The checkpoint key whose tensor holds program leaf ``name`` (a
    part of it, where torch packs several leaves into one key), or None
    for a leaf the checkpoint lacks."""
    for pat, repl in _RULES:
        m = re.fullmatch(pat, name)
        if m:
            return None if repl is None else m.expand(repl)
    raise KeyError(f"no checkpoint key for program leaf {name!r}")


def leaf_norms(tensors: Mapping[str, torch.Tensor],
               names: Sequence[str]) -> Dict[str, float]:
    """Norms of program leaves by checkpoint key: the leaves packed into
    one key are summed in squares; a patch embedding holds the
    convolution's elements in another order (the same norm)."""
    sq: Dict[str, float] = {}
    for n in names:
        key = checkpoint_key(n)
        if key is not None:
            sq[key] = sq.get(key, 0.0) + float(
                tensors[n].double().pow(2).sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


# ---- operations ------------------------------------------------------------
# Model FLOPs count the matrix products the inputs need, two per
# multiply-add, three times the forward's for a training step
# (flops.py's rule); attention counts the (query, key) pairs its mask
# lets through.


def vision_fwd(c: Mapping, frames: int) -> float:
    """The BLIP ViT over ``frames`` frames."""
    v = c["vision_config"]
    d, f, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    t = ref.tokens_per_frame(c)
    patch = 2.0 * (t - 1) * v["num_channels"] * p * p * d
    layer = 2.0 * t * d * (4 * d + 2 * f) + 4.0 * t * t * d
    return frames * (patch + v["num_hidden_layers"] * layer)


def text_fwd(c: Mapping, frame_tokens: int, text_len: int,
             valid: int) -> float:
    """One question's text encoder over its video's ``frame_tokens``."""
    t = c["text_config"]
    d, f = t["hidden_size"], t["intermediate_size"]
    dv = c["vision_config"]["hidden_size"]
    n = text_len
    layer = (2.0 * n * d * 4 * d + 4.0 * d * n * valid         # self
             + 2.0 * n * d * 2 * d + 2.0 * frame_tokens * dv * 2 * d
             + 4.0 * d * n * frame_tokens                       # cross
             + 2.0 * n * d * 2 * f)                             # FFN
    return t["num_hidden_layers"] * layer


def head_fwd(c: Mapping, frames: int, text_len: int, valid: int) -> float:
    """One question's fusion layers over [zero; text] and its classifier
    at position 0."""
    h = c["answer_head"]
    d = c["text_config"]["hidden_size"]
    dv = c["vision_config"]["hidden_size"]
    n = text_len + 1
    layer = (2.0 * n * d * 4 * d + 4.0 * d * n * (valid + 1)
             + 2.0 * n * d * 2 * d + 2.0 * frames * dv * 2 * d
             + 4.0 * d * n * frames
             + 2.0 * n * d * 2 * h["ffn_scale"] * d)
    width = h["cls_hidden_scale"] * d if h["classifier"] == "mlp" else d
    cls = 2.0 * d * width if h["classifier"] == "mlp" else 0.0
    return h["fusion_layers"] * layer + cls + 2.0 * width * h["num_labels"]


def train_micro(c: Mapping, frames_per_row: int, text_len: int,
                valid: Sequence[int]) -> float:
    """Model FLOPs of one training micro-batch (one video a row)."""
    m = frames_per_row * ref.tokens_per_frame(c)
    fwd = vision_fwd(c, frames_per_row * len(valid))
    for n in valid:
        fwd += text_fwd(c, m, text_len, int(n)) \
            + head_fwd(c, frames_per_row, text_len, int(n))
    return 3.0 * fwd


def update_flops(c: Mapping, shape, lens) -> float:
    """Model FLOPs of one update: ``shape`` is (micros, rows, frames,
    text length), ``lens`` each row's unpadded text length a micro."""
    return sum(train_micro(c, shape[2], shape[3], micro) for micro in lens)


def flash_bounds(b: int, h: int, s: int, dh: int) -> Dict[str, float]:
    """Least seconds of one K5 launch and of each of K6's two over
    (b, h, s, dh) self-attention with no bias: max(operations / 989
    TFLOP/s, bytes / 3.35 TB/s).  b * h * s * s pairs at 4, 6 and 8
    times dh FLOP (S and PV; S, dP and dQ; S, dP, dV and dK); each input
    read and each output written once: bf16 (b, h, s, dh) tensors (Q, K,
    V in and O out; Q, K, V, dO in and dQ out; the same four in and dK,
    dV out), the f32 row statistics (LSE, and D = rowsum(dO * O) for the
    backward, which ``rowsum_product`` reads O for before K6)."""
    pairs = b * h * s * s
    x, row = b * h * s * dh * 2, b * h * s * 4

    def least(ops, nbytes):
        return max(ops / flops.PEAK_BF16_FLOPS,
                   nbytes / flops.PEAK_BYTES_PER_S)

    return {"fwd": least(4 * dh * pairs, 4 * x + row),
            "dq": least(6 * dh * pairs, 5 * x + 2 * row),
            "dkv": least(8 * dh * pairs, 6 * x + 2 * row)}


# device-record needles of K5 and K6's two launches
FLASH_KERNELS = {"fwd": "flash_fwd_sm90", "dq": "flash_bwd_dq_sm90",
                 "dkv": "flash_bwd_dkv_sm90"}


def profiled(c: Mapping, p: Dict[str, Any]) -> Dict[str, Any]:
    """The profiled update: its device summary, and for K5 and K6 the
    (count, device seconds) of their records (``flash``), the launches
    an update makes of each (``flash_launches``: a vision layer a micro)
    and their summed least seconds (``flash_bound_s``)."""
    prof, shape = p["prof"], p["shape"]
    v = c["vision_config"]
    micros = int(shape[0])
    launches = micros * v["num_hidden_layers"]
    heads = v["num_attention_heads"]
    one = flash_bounds(int(shape[1]) * int(shape[2]), heads,
                       ref.tokens_per_frame(c), v["hidden_size"] // heads)
    return {"summary": trace.summary(prof), "micros": micros,
            "flash": {k: trace.device_seconds(prof, needle)
                      for k, needle in FLASH_KERNELS.items()},
            "flash_launches": launches,
            "flash_bound_s": {k: launches * s for k, s in one.items()},
            "prof": prof}
