"""Parameter converters (counterpart of sasvqa_tpu/models/convert.py).

Two routes meet in the Flax parameter layout (nested dicts of numpy
arrays under the JAX package's module names):

- HF PyTorch state dict -> Flax layout: ``convert_clip_text``,
  ``convert_clip_vision``, ``convert_git``, ``convert_blip_vision``,
  ``convert_blip_text``, ``convert_clip_video_qa``,
  ``convert_blip_video_qa`` (a published BLIP checkpoint, with or without
  the answer head), and the reference's whole finetuned classifiers
  ``convert_clip_classifier`` / ``convert_blip_classifier`` (copies of
  the JAX package's converters);
- Flax layout -> the port's modules: :func:`state_dict_from_flax` (a whole
  tree, strict) and :func:`merge_pretrained` (an overlay onto a built
  model that keeps what the checkpoint lacks or gets wrong, and reports
  it with the JAX package's paths).

The port's submodules carry the Flax parameter paths' names, so the
second route is one rule per leaf:

- ``kernel`` (in, out)  -> ``weight`` (out, in), transposed
- ``scale``             -> ``weight``   (LayerNorm)
- ``embedding``         -> ``weight``   (Embed)
- ``bias``              -> ``bias``
- ``class_embedding``, ``position_embedding`` (raw parameters) ->
  themselves

HF -> Flax conventions:

- torch ``Linear.weight`` (out, in) -> flax ``kernel`` (in, out)
- torch ``LayerNorm.weight/bias``   -> flax ``scale``/``bias``
- torch ``Embedding.weight``        -> flax ``embedding``
- patch conv kernel (D, C, p, p)    -> unfold Dense kernel (p*p*C, D) via
  ``transpose(2, 3, 1, 0).reshape(p*p*C, D)`` (the (ph, pw, c) flatten
  order of models/layers.PatchEmbed)
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from sasvqa_torch.models.layers import Dense, Embed, LayerNorm

# ---------------------------------------------------------------------------
# Flax layout -> the port


def _port_value(leaf: str, arr) -> torch.Tensor:
    """A Flax leaf's array as the port parameter's f32 tensor."""
    arr = np.asarray(arr)
    return torch.from_numpy(np.array(arr.T if leaf == "kernel" else arr,
                                     dtype=np.float32))


_PORT_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
              "bias": "bias", "class_embedding": "class_embedding",
              "position_embedding": "position_embedding"}


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (``model.init(...)["params"]`` as numpy, or
    the whole ``{"params": ...}`` variables) -> ``{dotted name: tensor}``
    for ``load_state_dict(strict=True)``."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, val in tree.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, path)
            elif key in _PORT_LEAF:
                name = _PORT_LEAF[key]
                out[f"{prefix}.{name}" if prefix else name] = \
                    _port_value(key, val)
            else:
                raise KeyError(f"no conversion rule for Flax leaf {path!r}")

    walk(params, "")
    return out


_FLAX_LEAF = ((Dense, "kernel"), (LayerNorm, "scale"), (Embed, "embedding"))


def flax_param_names(model: nn.Module) -> Dict[str, str]:
    """Port parameter name -> the JAX package's dotted parameter path
    (the port calls the Flax leaves ``kernel``/``scale``/``embedding``
    ``weight``; every other name is the same)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            flax_leaf = leaf
            if leaf == "weight":
                flax_leaf = next((f for cls, f in _FLAX_LEAF
                                  if isinstance(mod, cls)), leaf)
            prefix = f"{mod_name}." if mod_name else ""
            out[prefix + leaf] = prefix + flax_leaf
    return out


@torch.no_grad()
def merge_pretrained(model: nn.Module, converted: Mapping[str, Any]
                     ) -> Dict[str, List[str]]:
    """Overlay converted weights (Flax layout) onto ``model``'s
    parameters in place, keeping every leaf the checkpoint lacks (e.g.
    the classifier head) at its init value.

    Shape-mismatch tolerant like the JAX package's ``merge_pretrained``
    (the reference's ``load_state_dict_with_mismatch``): a mismatched leaf
    keeps its init value and is reported.  The report has the JAX
    package's paths (``/txt_model/layers_0/...``), order (sorted keys at
    every level) and granularity (``missing_in_ckpt`` names the first
    path the checkpoint lacks, not every leaf under it); shapes are
    reported in the Flax layout."""
    params = dict(model.named_parameters())
    tree: Dict[str, Any] = {}
    for name, flax in flax_param_names(model).items():
        *parents, leaf = flax.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = name
    report: Dict[str, List[str]] = {"loaded": [], "mismatched": [],
                                    "missing_in_ckpt": []}

    def merge(dst: Mapping[str, Any], src: Mapping[str, Any], path: str):
        for key in sorted(dst):
            kpath = f"{path}/{key}"
            if key not in src:
                report["missing_in_ckpt"].append(kpath)
            elif isinstance(dst[key], dict):
                merge(dst[key], src[key], kpath)
            else:
                param = params[dst[key]]
                arr = np.asarray(src[key])
                want = tuple(param.shape)
                if key == "kernel":
                    want = want[::-1]
                if arr.shape != want:
                    report["mismatched"].append(
                        f"{kpath}: ckpt {arr.shape} vs model {want}")
                else:
                    report["loaded"].append(kpath)
                    param.copy_(_port_value(key, arr))

    merge(tree, converted, "")
    return report


# ---------------------------------------------------------------------------
# HF PyTorch state dict -> Flax layout


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _lin(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).T,
            "bias": _np(sd[f"{prefix}.bias"])}


def _lin_nobias(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).T}


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _emb(sd, prefix):
    return {"embedding": _np(sd[f"{prefix}.weight"])}


def _patch_embed(sd, prefix, use_bias=False):
    w = _np(sd[f"{prefix}.weight"])            # (D, C, p, p)
    d = w.shape[0]
    kernel = w.transpose(2, 3, 1, 0).reshape(-1, d)
    out = {"proj": {"kernel": kernel}}
    if use_bias:
        out["proj"]["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _preln_block(sd, p):
    """CLIP-style encoder layer -> the fused-QKV layout
    (layers.FusedSelfAttention): HF's separate q/k/v kernels concatenate
    on the output axis in q, k, v order."""
    qw = _np(sd[f"{p}.self_attn.q_proj.weight"]).T
    kw = _np(sd[f"{p}.self_attn.k_proj.weight"]).T
    vw = _np(sd[f"{p}.self_attn.v_proj.weight"]).T
    qb = _np(sd[f"{p}.self_attn.q_proj.bias"])
    kb = _np(sd[f"{p}.self_attn.k_proj.bias"])
    vb = _np(sd[f"{p}.self_attn.v_proj.bias"])
    return {
        "self_attn": {
            "qkv": {"kernel": np.concatenate([qw, kw, vw], axis=1),
                    "bias": np.concatenate([qb, kb, vb])},
            "out_proj": _lin(sd, f"{p}.self_attn.out_proj"),
        },
        "layer_norm1": _ln(sd, f"{p}.layer_norm1"),
        "layer_norm2": _ln(sd, f"{p}.layer_norm2"),
        "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"),
                "fc2": _lin(sd, f"{p}.mlp.fc2")},
    }


def _blip_vision_block(sd, p):
    """BLIP vision layer: HF stores QKV already fused as (3D, D)."""
    return {
        "self_attn": {
            "qkv": {"kernel": _np(sd[f"{p}.self_attn.qkv.weight"]).T,
                    "bias": _np(sd[f"{p}.self_attn.qkv.bias"])},
            "out_proj": _lin(sd, f"{p}.self_attn.projection"),
        },
        "layer_norm1": _ln(sd, f"{p}.layer_norm1"),
        "layer_norm2": _ln(sd, f"{p}.layer_norm2"),
        "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"),
                "fc2": _lin(sd, f"{p}.mlp.fc2")},
    }


def _bert_attention(sd, p):
    """BERT attention: {p}.self.{query,key,value} + {p}.output.{dense,LayerNorm}."""
    return {
        "query": _lin(sd, f"{p}.self.query"),
        "key": _lin(sd, f"{p}.self.key"),
        "value": _lin(sd, f"{p}.self.value"),
        "out_dense": _lin(sd, f"{p}.output.dense"),
        "out_ln": _ln(sd, f"{p}.output.LayerNorm"),
    }


def _bert_attention_fused(sd, p):
    """BERT attention -> the fused QKV layout (GIT's attention)."""
    qw = _np(sd[f"{p}.self.query.weight"]).T
    kw = _np(sd[f"{p}.self.key.weight"]).T
    vw = _np(sd[f"{p}.self.value.weight"]).T
    qb = _np(sd[f"{p}.self.query.bias"])
    kb = _np(sd[f"{p}.self.key.bias"])
    vb = _np(sd[f"{p}.self.value.bias"])
    return {
        "qkv": {"kernel": np.concatenate([qw, kw, vw], axis=1),
                "bias": np.concatenate([qb, kb, vb])},
        "out_dense": _lin(sd, f"{p}.output.dense"),
        "out_ln": _ln(sd, f"{p}.output.LayerNorm"),
    }


def convert_clip_text(sd: Mapping[str, Any], num_layers: int,
                      prefix: str = "text_model") -> Dict[str, Any]:
    """HF CLIPTextModel state dict -> CLIPTextEncoder params.  Picks up
    ``text_projection`` when present (full-CLIPModel checkpoints)."""
    params = {
        "token_embedding": _emb(sd, f"{prefix}.embeddings.token_embedding"),
        "position_embedding": _emb(
            sd, f"{prefix}.embeddings.position_embedding"),
        "final_layer_norm": _ln(sd, f"{prefix}.final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        params["text_projection"] = _lin_nobias(sd, "text_projection")
    for i in range(num_layers):
        params[f"layers_{i}"] = _preln_block(
            sd, f"{prefix}.encoder.layers.{i}")
    return params


def convert_clip_vision(sd: Mapping[str, Any], num_layers: int,
                        prefix: str = "vision_model",
                        projection_key: str = "visual_projection",
                        ) -> Dict[str, Any]:
    """HF CLIPVisionModel(WithProjection) state dict -> CLIPVisionEncoder
    params; ``projection_key=""`` leaves the projection out (GIT)."""
    params = {
        "class_embedding": _np(sd[f"{prefix}.embeddings.class_embedding"]),
        "patch_embedding": _patch_embed(
            sd, f"{prefix}.embeddings.patch_embedding", use_bias=False),
        "position_embedding": _emb(
            sd, f"{prefix}.embeddings.position_embedding"),
        "pre_layrnorm": _ln(sd, f"{prefix}.pre_layrnorm"),
        "post_layernorm": _ln(sd, f"{prefix}.post_layernorm"),
    }
    for i in range(num_layers):
        params[f"layers_{i}"] = _preln_block(
            sd, f"{prefix}.encoder.layers.{i}")
    if projection_key and f"{projection_key}.weight" in sd:
        params["visual_projection"] = _lin_nobias(sd, projection_key)
    return params


def convert_git(sd: Mapping[str, Any], num_layers: int,
                num_vision_layers: int) -> Dict[str, Any]:
    """HF GitForCausalLM state dict -> GITForCausalLM params.

    ``git.img_temporal_embedding`` (created when num_image_with_embedding
    is set) is dropped: the reference fork never adds it (its
    modeling.py:86), so it stays zero-initialised and contributes
    nothing."""
    params = {
        "image_encoder": convert_clip_vision(
            sd, num_vision_layers,
            prefix="git.image_encoder.vision_model", projection_key=""),
        "visual_projection": _lin(
            sd, "git.visual_projection.visual_projection.0"),
        "visual_projection_ln": _ln(
            sd, "git.visual_projection.visual_projection.1"),
        "word_embeddings": _emb(sd, "git.embeddings.word_embeddings"),
        "position_embeddings": _emb(sd, "git.embeddings.position_embeddings"),
        "emb_ln": _ln(sd, "git.embeddings.LayerNorm"),
        "output": _lin(sd, "output"),
    }
    for i in range(num_layers):
        p = f"git.encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": _bert_attention_fused(sd, f"{p}.attention"),
            "ffn": {
                "intermediate": _lin(sd, f"{p}.intermediate.dense"),
                "output": _lin(sd, f"{p}.output.dense"),
                "ln": _ln(sd, f"{p}.output.LayerNorm"),
            },
        }
    return params


def convert_blip_vision(sd: Mapping[str, Any], num_layers: int,
                        prefix: str = "") -> Dict[str, Any]:
    """Standalone ``BlipVisionModel`` state dicts carry no prefix; pass
    ``prefix='vision_model'`` for a full BlipModel."""
    pre = f"{prefix}." if prefix else ""
    params = {
        "class_embedding": _np(sd[f"{pre}embeddings.class_embedding"]),
        "patch_embedding": _patch_embed(
            sd, f"{pre}embeddings.patch_embedding", use_bias=True),
        "position_embedding": _np(sd[f"{pre}embeddings.position_embedding"]),
        "post_layernorm": _ln(sd, f"{pre}post_layernorm"),
    }
    for i in range(num_layers):
        params[f"layers_{i}"] = _blip_vision_block(
            sd, f"{pre}encoder.layers.{i}")
    return params


def convert_blip_text(sd: Mapping[str, Any], num_layers: int,
                      prefix: str = "",
                      cross_attention: bool = True) -> Dict[str, Any]:
    """HF BlipTextModel state dict -> BLIPTextEncoder params (the
    cross-attention sub-blocks and the pooler where the checkpoint has
    them: ``BlipForQuestionAnswering``'s text encoder has no pooler)."""
    pre = f"{prefix}." if prefix else ""
    params = {
        "word_embeddings": _emb(sd, f"{pre}embeddings.word_embeddings"),
        "position_embeddings": _emb(
            sd, f"{pre}embeddings.position_embeddings"),
        "emb_ln": _ln(sd, f"{pre}embeddings.LayerNorm"),
    }
    if f"{pre}pooler.dense.weight" in sd:
        params["pooler"] = _lin(sd, f"{pre}pooler.dense")
    for i in range(num_layers):
        p = f"{pre}encoder.layer.{i}"
        layer = {
            "attention": _bert_attention(sd, f"{p}.attention"),
            "ffn": {
                "intermediate": _lin(sd, f"{p}.intermediate.dense"),
                "output": _lin(sd, f"{p}.output.dense"),
                "ln": _ln(sd, f"{p}.output.LayerNorm"),
            },
        }
        if cross_attention and f"{p}.crossattention.self.query.weight" in sd:
            layer["crossattention"] = _bert_attention(sd, f"{p}.crossattention")
        params[f"layers_{i}"] = layer
    return params


def convert_clip_video_qa(sd: Mapping[str, Any], num_text_layers: int,
                          num_vision_layers: int) -> Dict[str, Any]:
    """Full CLIPModel (text + vision + projections) -> CLIPVideoQA
    encoder params (the fusion head and classifier stay at their init,
    as in the reference, which trains them from scratch)."""
    return {
        "txt_model": convert_clip_text(sd, num_text_layers),
        "vis_model": convert_clip_vision(sd, num_vision_layers),
    }


# ---------------------------------------------------------------------------
# torch.nn fusion-head layers (the reference's CrossAttentionLayer is built
# from torch.nn.TransformerDecoder, modeling.py:366-374)


def _torch_mha(sd, prefix):
    """torch.nn.MultiheadAttention -> the MultiHeadAttention
    {q,k,v,out}_proj params: the packed ``in_proj_weight`` (3D, D), or,
    where the keys are wider than the queries (``kdim``/``vdim``: a
    1024-wide vision tower under a 768-wide text stack), the separate
    ``{q,k,v}_proj_weight``; one packed ``in_proj_bias`` (3D) either
    way."""
    b = _np(sd[f"{prefix}.in_proj_bias"])
    d = b.shape[0] // 3
    if f"{prefix}.in_proj_weight" in sd:
        w = _np(sd[f"{prefix}.in_proj_weight"])
        ws = [w[i * d:(i + 1) * d] for i in range(3)]
    else:
        ws = [_np(sd[f"{prefix}.{n}_proj_weight"]) for n in "qkv"]

    def part(i):
        return {"kernel": ws[i].T, "bias": b[i * d:(i + 1) * d]}

    return {"q_proj": part(0), "k_proj": part(1), "v_proj": part(2),
            "out_proj": _lin(sd, f"{prefix}.out_proj")}


def _torch_decoder_layer(sd, p):
    """torch.nn.TransformerDecoderLayer -> fusion.TransformerDecoderLayer."""
    return {
        "self_attn": _torch_mha(sd, f"{p}.self_attn"),
        "cross_attn": _torch_mha(sd, f"{p}.multihead_attn"),
        "linear1": _lin(sd, f"{p}.linear1"),
        "linear2": _lin(sd, f"{p}.linear2"),
        "norm1": _ln(sd, f"{p}.norm1"),
        "norm2": _ln(sd, f"{p}.norm2"),
        "norm3": _ln(sd, f"{p}.norm3"),
    }


def _unwrap(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    """A ``CLIPModelforFinetune`` dict (the ``VLModel.`` wrapper prefix,
    the reference's clip_model.py:9-13) -> its inner model's keys."""
    if any(k.startswith("VLModel.") for k in sd):
        return {k[len("VLModel."):]: v for k, v in sd.items()
                if k.startswith("VLModel.")}
    return sd


def _answer_head(sd, n_fusion_layers):
    """The dec-only fusion layers and the classifier, with the MLP
    classifier's hidden layer ``cls_fc`` where the checkpoint has it."""
    head = {"attention": {f"layers_{i}": _torch_decoder_layer(
                sd, f"attention.attention.layers.{i}")
                for i in range(n_fusion_layers)},
            "classifier": _lin(sd, "classifier")}
    if "cls_fc.weight" in sd:
        head["cls_fc"] = _lin(sd, "cls_fc")
    return head


def convert_clip_classifier(sd: Mapping[str, Any], num_text_layers: int,
                            num_vision_layers: int,
                            n_fusion_layers: int = 1) -> Dict[str, Any]:
    """Reference ``CLIPForSeqClassification`` state dict (its
    src/modeling/modeling.py:393-448) -> ``CLIPVideoQA`` params: the whole
    finetuned model (CLIP text and vision towers, the dec-only
    CrossAttentionLayer, a torch TransformerDecoder, and the answer
    classifier, linear or MLP), so a reference-finetuned classifier
    checkpoint loads through :func:`merge_pretrained`.  ``VLModel.``-
    prefixed dicts are accepted too."""
    sd = _unwrap(sd)
    return {
        "txt_model": convert_clip_text(
            sd, num_text_layers, prefix="vlm.txt_model.text_model"),
        "vis_model": convert_clip_vision(
            sd, num_vision_layers, prefix="vlm.vis_model.vision_model",
            projection_key="vlm.vis_model.visual_projection"),
        "answer_head": _answer_head(sd, n_fusion_layers),
    }


def convert_blip_classifier(sd: Mapping[str, Any], num_text_layers: int,
                            num_vision_layers: int,
                            n_fusion_layers: int = 1) -> Dict[str, Any]:
    """Reference BLIP-family ``CLIPForSeqClassification`` state dict
    (modeling.py:393-411 over ``BLIPBaseModel``, :299-315) ->
    ``BLIPVideoQA`` params: the BLIP vision tower, the cross-attending
    BLIP text encoder, the dec-only CrossAttentionLayer and the answer
    classifier, linear or MLP.  ``VLModel.``-prefixed dicts are accepted
    too."""
    sd = _unwrap(sd)
    return {
        "txt_model": convert_blip_text(sd, num_text_layers,
                                       prefix="vlm.txt_model"),
        "vis_model": convert_blip_vision(sd, num_vision_layers,
                                         prefix="vlm.vis_model"),
        "answer_head": _answer_head(sd, n_fusion_layers),
    }


# BlipForQuestionAnswering's answer decoder, which the classifier never
# reads
BLIP_DECODER_PREFIX = "text_decoder."


def convert_blip_video_qa(sd: Mapping[str, Any], num_text_layers: int,
                          num_vision_layers: int) -> Dict[str, Any]:
    """A local BLIP checkpoint -> ``BLIPVideoQA`` params, its layout told
    by its keys: the published ``BlipForQuestionAnswering``
    (``vision_model.*``, ``text_encoder.*`` without a pooler, and the
    answer decoder ``text_decoder.*``, not read) or ``BlipModel``
    (``vision_model.*``, ``text_model.*``).  Where the checkpoint holds
    ``classifier.weight`` the answer head is read too, under the
    reference classifier's names (:func:`_answer_head`); otherwise it
    keeps its init."""
    text = "text_encoder" if any(k.startswith("text_encoder.")
                                 for k in sd) else "text_model"
    params = {"txt_model": convert_blip_text(sd, num_text_layers,
                                             prefix=text),
              "vis_model": convert_blip_vision(sd, num_vision_layers,
                                               prefix="vision_model")}
    if "classifier.weight" in sd:
        layers = {k.split(".")[3] for k in sd
                  if k.startswith("attention.attention.layers.")}
        params["answer_head"] = _answer_head(sd, len(layers))
    return params
