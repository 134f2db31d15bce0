"""Model presets + construction from a task config
(counterpart of sasvqa_tpu/models/presets.py, GIT and BLIP families).

``cfg`` is a mapping with ``cfg["model"]["pretrained_model"]`` naming the
checkpoint (``"microsoft/git-base-msrvtt-qa"``,
``"Salesforce/blip-vqa-base"``, ``"tiny-git"``, ``"tiny-blip"``, ...),
optional ``cfg["model"]["vocab_size"]`` / ``cfg["img_size"]`` overrides,
the GIT dropouts (``model.hidden_dropout_prob``,
``model.attention_probs_dropout_prob``) and vision-tower remat
(``remat``/``remat_policy`` in ``cfg["model"]`` or ``cfg``) and, for the
classifier families, the head settings (``num_labels``, ``loss_type``,
``classifier``, ``cls_hidden_scale``, ``model.hidden_dropout_prob``,
``model.attn_type``).  Weights are drawn
from a seeded generator: loading HF checkpoints is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple, Union

import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.models.blip import BLIPTextConfig, BLIPVisionConfig
from sasvqa_torch.models.clip import CLIP_VIT_L14_VISION, CLIPVisionConfig
from sasvqa_torch.models.git import GIT_BASE, GITConfig, GITForCausalLM
from sasvqa_torch.models.video_qa import BLIPVideoQA, ClassifierHeadConfig

TINY_VISION = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_layers=2, num_heads=4, image_size=32,
                               patch_size=16, projection_dim=32)


def model_family(pretrained_model: str) -> str:
    """Dispatch on the checkpoint name substring, as the reference does."""
    name = pretrained_model.lower()
    if "clip" in name and "blip" not in name:
        return "clip"
    if "blip" in name:
        return "blip"
    if "git" in name:
        return "git"
    raise ValueError(f"cannot infer model family from {pretrained_model!r}")


def _git_config(name: str) -> GITConfig:
    if "tiny" in name:
        return GITConfig(
            vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=128,
            vision=TINY_VISION)
    if "large" in name:
        # GIT-large uses ViT-L/14 vision
        return dataclasses.replace(GIT_BASE, hidden_size=768, num_layers=6,
                                   vision=CLIP_VIT_L14_VISION)
    return GIT_BASE


def _blip_configs(name: str) -> Tuple[BLIPTextConfig, BLIPVisionConfig]:
    if "tiny" in name:
        return (BLIPTextConfig(vocab_size=512, hidden_size=32,
                               intermediate_size=64, num_layers=2,
                               num_heads=4, max_position_embeddings=64,
                               encoder_width=32),
                BLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                 num_layers=2, num_heads=4, image_size=32,
                                 patch_size=16))
    if "large" in name:
        # encoder_width is the vision width the text stack cross-attends
        # over (blip-large: vision 1024, text 768)
        return (BLIPTextConfig(encoder_width=1024),
                BLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                                 num_layers=24, num_heads=16))
    return BLIPTextConfig(), BLIPVisionConfig()


def _head_config(cfg: Mapping[str, Any]) -> ClassifierHeadConfig:
    """The classifier head's settings from a task config, with the JAX
    package's defaults."""
    return ClassifierHeadConfig(
        num_labels=cfg.get("num_labels",
                           cfg["model"].get("num_labels", 1000)),
        loss_type=cfg.get("loss_type", "ce"),
        classifier=cfg.get("classifier", "linear"),
        cls_hidden_scale=cfg.get("cls_hidden_scale", 2),
        hidden_dropout_prob=cfg["model"].get("hidden_dropout_prob", 0.1),
        attn_type=cfg["model"].get("attn_type", "dec-only"))


def build_model(cfg: Mapping[str, Any], dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda",
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[str, Union[GITForCausalLM, BLIPVideoQA]]:
    """Construct the task model from ``cfg["model"]``; returns
    (family, model in eval mode on ``device``).  ``dtype`` is the
    activation dtype (parameters stay f32); weights come from
    ``generator`` (default: seeded with 0)."""
    dev = resolve_device(device)
    name = cfg["model"]["pretrained_model"].lower()
    family = model_family(name)
    vocab_override = cfg["model"].get("vocab_size")
    img_size = cfg.get("img_size")
    if family == "blip":
        tc, vc = _blip_configs(name)
        if vocab_override:
            tc = dataclasses.replace(tc, vocab_size=vocab_override)
        if img_size and img_size != vc.image_size:
            vc = dataclasses.replace(vc, image_size=img_size)
        model = BLIPVideoQA(tc, vc, _head_config(cfg), dtype=dtype,
                            generator=generator)
        return family, model.to(dev).eval()
    if family != "git":
        raise NotImplementedError(
            f"the {family} family is not ported yet (GIT and BLIP only)")
    gc = _git_config(name)
    if vocab_override:
        gc = dataclasses.replace(gc, vocab_size=vocab_override)
    # HF GitConfig knob names for both dropouts
    hd = cfg["model"].get("hidden_dropout_prob")
    if hd is not None:
        gc = dataclasses.replace(gc, dropout=float(hd))
    ad = cfg["model"].get("attention_probs_dropout_prob")
    if ad is not None:
        gc = dataclasses.replace(gc, attention_dropout=float(ad))
    if img_size and img_size != gc.vision.image_size:
        gc = dataclasses.replace(
            gc, vision=dataclasses.replace(gc.vision, image_size=img_size))
    remat = bool(cfg["model"].get("remat", cfg.get("remat", False)))
    remat_policy = cfg["model"].get("remat_policy",
                                    cfg.get("remat_policy", None)) or None
    model = GITForCausalLM(gc, dtype=dtype, generator=generator, remat=remat,
                           remat_policy=remat_policy)
    return family, model.to(dev).eval()
