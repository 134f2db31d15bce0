"""Seeded checkpoints in Hugging Face's key names, written without
``transformers``, and a check that a loaded model holds a checkpoint.

``hf_clip_shapes``, ``hf_clip_vision_shapes``, ``hf_git_shapes``,
``hf_blip_shapes`` and ``hf_bert_classifier_shapes`` give the state-dict
names and shapes of ``CLIPModel``, ``CLIPVisionModel``,
``GitForCausalLM``, ``BlipModel`` and ``BertForSequenceClassification``
for the port's configs; ``write_hf_checkpoint`` writes a
seeded ``pytorch_model.bin`` of such names that
``models.presets.load_pretrained_params`` reads like a saved HF model.
``check_loaded`` holds a model's parameters to a converted (Flax-layout)
tree of a checkpoint."""

import os
import time

import numpy as np
import torch

from sasvqa_torch.models.convert import flax_param_names


def _hf_preln_layer(shapes, prefix, d, ff):
    """One CLIP encoder layer's HF names and shapes."""
    for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
        shapes[f"{prefix}.self_attn.{proj}.weight"] = (d, d)
        shapes[f"{prefix}.self_attn.{proj}.bias"] = (d,)
    for ln in ("layer_norm1", "layer_norm2"):
        shapes[f"{prefix}.{ln}.weight"] = (d,)
        shapes[f"{prefix}.{ln}.bias"] = (d,)
    shapes[f"{prefix}.mlp.fc1.weight"] = (ff, d)
    shapes[f"{prefix}.mlp.fc1.bias"] = (ff,)
    shapes[f"{prefix}.mlp.fc2.weight"] = (d, ff)
    shapes[f"{prefix}.mlp.fc2.bias"] = (d,)


def _hf_clip_vision(shapes, prefix, vc):
    d = vc.hidden_size
    shapes[f"{prefix}.embeddings.class_embedding"] = (d,)
    shapes[f"{prefix}.embeddings.patch_embedding.weight"] = (
        d, 3, vc.patch_size, vc.patch_size)
    shapes[f"{prefix}.embeddings.position_embedding.weight"] = (
        (vc.image_size // vc.patch_size) ** 2 + 1, d)
    for ln in ("pre_layrnorm", "post_layernorm"):
        shapes[f"{prefix}.{ln}.weight"] = (d,)
        shapes[f"{prefix}.{ln}.bias"] = (d,)
    for i in range(vc.num_layers):
        _hf_preln_layer(shapes, f"{prefix}.encoder.layers.{i}", d,
                        vc.intermediate_size)


def hf_clip_shapes(tc, vc):
    """State-dict names and shapes of HF ``CLIPModel`` for the port's
    (CLIPTextConfig, CLIPVisionConfig), written without transformers (the
    card's installation has none)."""
    d = tc.hidden_size
    shapes = {"logit_scale": (),
              "text_model.embeddings.token_embedding.weight":
                  (tc.vocab_size, d),
              "text_model.embeddings.position_embedding.weight":
                  (tc.max_position_embeddings, d)}
    for i in range(tc.num_layers):
        _hf_preln_layer(shapes, f"text_model.encoder.layers.{i}", d,
                        tc.intermediate_size)
    shapes["text_model.final_layer_norm.weight"] = (d,)
    shapes["text_model.final_layer_norm.bias"] = (d,)
    _hf_clip_vision(shapes, "vision_model", vc)
    shapes["visual_projection.weight"] = (vc.projection_dim, vc.hidden_size)
    shapes["text_projection.weight"] = (vc.projection_dim, d)
    return shapes


def hf_clip_vision_shapes(vc):
    """State-dict names and shapes of HF ``CLIPVisionModel`` for the
    port's CLIPVisionConfig (the MDF encoder's ``--vision_weights``)."""
    shapes = {}
    _hf_clip_vision(shapes, "vision_model", vc)
    return shapes


def hf_bert_classifier_shapes(bc):
    """State-dict names and shapes of HF ``BertForSequenceClassification``
    for the port's BERTConfig (stage B's scorer)."""
    d, ff = bc.hidden_size, bc.intermediate_size
    shapes = {"bert.embeddings.word_embeddings.weight": (bc.vocab_size, d),
              "bert.embeddings.position_embeddings.weight":
                  (bc.max_position_embeddings, d),
              "bert.embeddings.token_type_embeddings.weight":
                  (bc.type_vocab_size, d),
              "bert.embeddings.LayerNorm.weight": (d,),
              "bert.embeddings.LayerNorm.bias": (d,)}
    for i in range(bc.num_layers):
        p = f"bert.encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            shapes[f"{p}.{name}.weight"] = (d, d)
            shapes[f"{p}.{name}.bias"] = (d,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{ln}.weight"] = (d,)
            shapes[f"{p}.{ln}.bias"] = (d,)
        shapes[f"{p}.intermediate.dense.weight"] = (ff, d)
        shapes[f"{p}.intermediate.dense.bias"] = (ff,)
        shapes[f"{p}.output.dense.weight"] = (d, ff)
        shapes[f"{p}.output.dense.bias"] = (d,)
    shapes["bert.pooler.dense.weight"] = (d, d)
    shapes["bert.pooler.dense.bias"] = (d,)
    shapes["classifier.weight"] = (bc.num_labels, d)
    shapes["classifier.bias"] = (bc.num_labels,)
    return shapes


def hf_git_shapes(gc, num_frames):
    """State-dict names and shapes of HF ``GitForCausalLM`` for the
    port's GITConfig, with the temporal embeddings of ``num_frames``
    frames (``num_image_with_embedding``)."""
    d, ff = gc.hidden_size, gc.intermediate_size
    shapes = {"git.embeddings.word_embeddings.weight": (gc.vocab_size, d),
              "git.embeddings.position_embeddings.weight":
                  (gc.max_position_embeddings, d),
              "git.embeddings.LayerNorm.weight": (d,),
              "git.embeddings.LayerNorm.bias": (d,)}
    _hf_clip_vision(shapes, "git.image_encoder.vision_model", gc.vision)
    for i in range(gc.num_layers):
        p = f"git.encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            shapes[f"{p}.{name}.weight"] = (d, d)
            shapes[f"{p}.{name}.bias"] = (d,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{ln}.weight"] = (d,)
            shapes[f"{p}.{ln}.bias"] = (d,)
        shapes[f"{p}.intermediate.dense.weight"] = (ff, d)
        shapes[f"{p}.intermediate.dense.bias"] = (ff,)
        shapes[f"{p}.output.dense.weight"] = (d, ff)
        shapes[f"{p}.output.dense.bias"] = (d,)
    vp = "git.visual_projection.visual_projection"
    shapes[f"{vp}.0.weight"] = (d, gc.vision.hidden_size)
    shapes[f"{vp}.0.bias"] = (d,)
    shapes[f"{vp}.1.weight"] = (d,)
    shapes[f"{vp}.1.bias"] = (d,)
    for i in range(num_frames):
        shapes[f"git.img_temporal_embedding.{i}"] = (1, 1, d)
    shapes["output.weight"] = (gc.vocab_size, d)
    shapes["output.bias"] = (gc.vocab_size,)
    return shapes


def hf_blip_shapes(tc, vc, projection_dim=512):
    """State-dict names and shapes of HF ``BlipModel`` (its vision model
    and cross-attending text model) for the port's (BLIPTextConfig,
    BLIPVisionConfig)."""
    d, dv = tc.hidden_size, vc.hidden_size
    shapes = {"logit_scale": (),
              "text_model.embeddings.word_embeddings.weight":
                  (tc.vocab_size, d),
              "text_model.embeddings.position_embeddings.weight":
                  (tc.max_position_embeddings, d),
              "text_model.embeddings.LayerNorm.weight": (d,),
              "text_model.embeddings.LayerNorm.bias": (d,)}
    for i in range(tc.num_layers):
        p = f"text_model.encoder.layer.{i}"
        for att, kv in (("attention", d), ("crossattention",
                                           tc.encoder_width)):
            shapes[f"{p}.{att}.self.query.weight"] = (d, d)
            shapes[f"{p}.{att}.self.query.bias"] = (d,)
            for name in ("key", "value"):
                shapes[f"{p}.{att}.self.{name}.weight"] = (d, kv)
                shapes[f"{p}.{att}.self.{name}.bias"] = (d,)
            shapes[f"{p}.{att}.output.dense.weight"] = (d, d)
            shapes[f"{p}.{att}.output.dense.bias"] = (d,)
            shapes[f"{p}.{att}.output.LayerNorm.weight"] = (d,)
            shapes[f"{p}.{att}.output.LayerNorm.bias"] = (d,)
        shapes[f"{p}.intermediate.dense.weight"] = (tc.intermediate_size, d)
        shapes[f"{p}.intermediate.dense.bias"] = (tc.intermediate_size,)
        shapes[f"{p}.output.dense.weight"] = (d, tc.intermediate_size)
        shapes[f"{p}.output.dense.bias"] = (d,)
        shapes[f"{p}.output.LayerNorm.weight"] = (d,)
        shapes[f"{p}.output.LayerNorm.bias"] = (d,)
    shapes["text_model.pooler.dense.weight"] = (d, d)
    shapes["text_model.pooler.dense.bias"] = (d,)
    shapes["vision_model.embeddings.class_embedding"] = (1, 1, dv)
    shapes["vision_model.embeddings.position_embedding"] = (
        1, vc.tokens_per_frame, dv)
    shapes["vision_model.embeddings.patch_embedding.weight"] = (
        dv, 3, vc.patch_size, vc.patch_size)
    shapes["vision_model.embeddings.patch_embedding.bias"] = (dv,)
    for i in range(vc.num_layers):
        p = f"vision_model.encoder.layers.{i}"
        shapes[f"{p}.self_attn.qkv.weight"] = (3 * dv, dv)
        shapes[f"{p}.self_attn.qkv.bias"] = (3 * dv,)
        shapes[f"{p}.self_attn.projection.weight"] = (dv, dv)
        shapes[f"{p}.self_attn.projection.bias"] = (dv,)
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[f"{p}.{ln}.weight"] = (dv,)
            shapes[f"{p}.{ln}.bias"] = (dv,)
        shapes[f"{p}.mlp.fc1.weight"] = (vc.intermediate_size, dv)
        shapes[f"{p}.mlp.fc1.bias"] = (vc.intermediate_size,)
        shapes[f"{p}.mlp.fc2.weight"] = (dv, vc.intermediate_size)
        shapes[f"{p}.mlp.fc2.bias"] = (dv,)
    shapes["vision_model.post_layernorm.weight"] = (dv,)
    shapes["vision_model.post_layernorm.bias"] = (dv,)
    shapes["visual_projection.weight"] = (projection_dim, dv)
    shapes["text_projection.weight"] = (projection_dim, d)
    return shapes


def seeded_hf_state_dict(shapes, seed):
    """f32 CPU tensors for ``shapes`` from ``seed``: LayerNorm scales (the
    1-D ``.weight`` leaves) 1 + 0.02 N(0, 1), every other leaf
    0.02 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        val = 0.02 * torch.randn(shape, generator=gen)
        if len(shape) == 1 and name.endswith(".weight"):
            val += 1.0
        out[name] = val
    return out


def write_hf_checkpoint(root, shapes, seed):
    """A seeded ``pytorch_model.bin`` under ``root``; returns
    (directory, state dict, seconds to write)."""
    sd = seeded_hf_state_dict(shapes, seed)
    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    return root, sd, time.perf_counter() - t0


def check_loaded(model, converted):
    """Every parameter of ``model`` with a leaf in ``converted`` (the
    Flax-layout tree of a checkpoint) holds that leaf's bits; returns the
    number of parameters compared and the names that differ."""
    compared, differ = 0, []
    for name, flax in flax_param_names(model).items():
        node = converted
        for part in flax.split("."):
            node = node.get(part) if isinstance(node, dict) else None
        if node is None:
            continue
        want = np.asarray(node)
        if flax.endswith(".kernel"):
            want = want.T
        got = model.get_parameter(name).detach().cpu()
        compared += 1
        if not torch.equal(got, torch.from_numpy(np.ascontiguousarray(
                want, dtype=np.float32))):
            differ.append(name)
    return compared, differ
