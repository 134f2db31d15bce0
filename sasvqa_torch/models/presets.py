"""Model presets, construction from a task config and the local HF weight
loader (counterpart of sasvqa_tpu/models/presets.py).

``cfg`` is a mapping with ``cfg["model"]["pretrained_model"]`` naming the
checkpoint (``"microsoft/git-base-msrvtt-qa"``,
``"openai/clip-vit-base-patch16"``, ``"Salesforce/blip-vqa-base"``,
``"tiny-git"``, ``"tiny-clip"``, ``"tiny-blip"``, ...),
optional ``cfg["model"]["vocab_size"]`` / ``cfg["img_size"]`` overrides,
the GIT dropouts (``model.hidden_dropout_prob``,
``model.attention_probs_dropout_prob``) and vision-tower remat
(``remat``/``remat_policy`` in ``cfg["model"]`` or ``cfg``) and, for the
classifier families, the head settings (``num_labels``, ``loss_type``,
``classifier``, ``cls_hidden_scale``, ``model.hidden_dropout_prob``,
``model.attn_type``); ``task`` ``action`` or ``transition`` builds the
multiple-choice scorer of a classifier family.  Weights are drawn
from a seeded generator; :func:`load_pretrained_params` then overlays a
local HF checkpoint (no hub downloads).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.models import convert as cv
from sasvqa_torch.models.blip import BLIPTextConfig, BLIPVisionConfig
from sasvqa_torch.models.clip import (CLIP_VIT_B16, CLIP_VIT_B32,
                                      CLIP_VIT_L14, CLIP_VIT_L14_VISION,
                                      CLIPTextConfig, CLIPVisionConfig)
from sasvqa_torch.models.git import GIT_BASE, GITConfig, GITForCausalLM
from sasvqa_torch.models.video_qa import (BLIPVideoQA, ClassifierHeadConfig,
                                          CLIPVideoQA)

# the TGIF-QA multiple-choice tasks (5 options a question)
MC_TASKS = ("action", "transition")

TINY_VISION = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_layers=2, num_heads=4, image_size=32,
                               patch_size=16, projection_dim=32)
TINY_TEXT = CLIPTextConfig(vocab_size=512, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4,
                           max_position_embeddings=32, eos_token_id=511)


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


def _clip_configs(name: str) -> Tuple[CLIPTextConfig, CLIPVisionConfig]:
    if "tiny" in name:
        return TINY_TEXT, TINY_VISION
    if "large-patch14" in name or "l14" in name:
        return CLIP_VIT_L14
    if "patch16" in name or "b16" in name:
        return CLIP_VIT_B16
    return CLIP_VIT_B32


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
                ) -> Tuple[str, Union[GITForCausalLM, CLIPVideoQA,
                                      BLIPVideoQA]]:
    """Construct the task model from ``cfg["model"]``; returns
    (family, model in eval mode on ``device``).  ``dtype`` is the
    activation dtype (parameters stay f32); weights come from
    ``generator`` (default: seeded with 0).  A multiple-choice ``task``
    (TGIF-QA ``action``/``transition``) builds the CLIP or BLIP model
    with ``mc_head`` instead of ``answer_head``; GIT has no scoring head
    and raises ``ValueError`` for it."""
    dev = resolve_device(device)
    name = cfg["model"]["pretrained_model"].lower()
    family = model_family(name)
    mc = cfg.get("task") in MC_TASKS
    if mc and family == "git":
        raise ValueError(
            f"{cfg.get('task')} multiple-choice requires a clip/blip model; "
            f"the GIT generative path has no MC scoring head")
    vocab_override = cfg["model"].get("vocab_size")
    img_size = cfg.get("img_size")
    if family == "clip":
        tc, vc = _clip_configs(name)
        if vocab_override:
            tc = dataclasses.replace(tc, vocab_size=vocab_override,
                                     eos_token_id=vocab_override - 1)
        if img_size and img_size != vc.image_size:
            vc = dataclasses.replace(vc, image_size=img_size)
        model = CLIPVideoQA(tc, vc, _head_config(cfg), dtype=dtype,
                            generator=generator, multiple_choice=mc)
        return family, model.to(dev).eval()
    if family == "blip":
        tc, vc = _blip_configs(name)
        if vocab_override:
            tc = dataclasses.replace(tc, vocab_size=vocab_override)
        if img_size and img_size != vc.image_size:
            vc = dataclasses.replace(vc, image_size=img_size)
        model = BLIPVideoQA(tc, vc, _head_config(cfg), dtype=dtype,
                            generator=generator, multiple_choice=mc)
        return family, model.to(dev).eval()
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


def _load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A local HF checkpoint (a directory holding ``model.safetensors``
    or ``pytorch_model.bin``, or one of those files) as a numpy state
    dict."""
    if os.path.isdir(path):
        for fname in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, fname)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_pretrained_params(family: str, model, weights_path: str
                           ) -> Dict[str, List[str]]:
    """Overlay the converted weights of a local HF checkpoint onto
    ``model`` in place, shape-tolerantly (reference: ``from_pretrained``
    plus ``load_state_dict_with_mismatch``); returns the
    :func:`models.convert.merge_pretrained` report, and in it, where the
    checkpoint holds keys the family does not read (a BLIP VQA
    checkpoint's ``text_decoder.*``), ``skipped_in_ckpt``: those keys.
    A BLIP checkpoint may be the published ``BlipForQuestionAnswering``
    or a ``BlipModel``, with or without the answer head
    (:func:`models.convert.convert_blip_video_qa`)."""
    sd = _load_torch_state_dict(weights_path)
    skipped: List[str] = []
    if family == "clip":
        converted = cv.convert_clip_video_qa(
            sd, model.text_config.num_layers, model.vision_config.num_layers)
    elif family == "blip":
        converted = cv.convert_blip_video_qa(
            sd, model.text_config.num_layers, model.vision_config.num_layers)
        skipped = sorted(k for k in sd
                         if k.startswith(cv.BLIP_DECODER_PREFIX))
    elif family == "git":
        converted = cv.convert_git(sd, model.config.num_layers,
                                   model.config.vision.num_layers)
    else:
        raise ValueError(family)
    report = cv.merge_pretrained(model, converted)
    LOGGER.info(
        f"loaded {len(report['loaded'])} tensors from {weights_path}; "
        f"{len(report['missing_in_ckpt'])} kept from init; "
        f"{len(report['mismatched'])} shape mismatches")
    if skipped:
        report["skipped_in_ckpt"] = skipped
        LOGGER.info(f"  not read: {len(skipped)} tensors under "
                    f"{cv.BLIP_DECODER_PREFIX}* (BLIP's answer decoder, "
                    f"which the classifier does not use)")
    for line in report["mismatched"]:
        LOGGER.warning(f"  mismatch: {line}")
    return report
