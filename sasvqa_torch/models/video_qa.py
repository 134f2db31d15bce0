"""Classifier video-QA models (counterpart of sasvqa_tpu/models/video_qa.py):
the loss selection of the reference's ``calc_loss``, :class:`CLIPVideoQA`
and :class:`BLIPVideoQA`, each either an answer classifier (``forward``,
with ``answer_head``) or a TGIF-QA multiple-choice scorer
(``multiple_choice=True``: ``multiple_choice``, with ``mc_head``).

Models take a fixed-shape frame tensor (B, T, H, W, C); ``input_ids`` may
hold several examples (or option rows) per video (B a multiple of the
video count), and the encoded video repeats after the encoder, so the ViT
runs once per video.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sasvqa_torch.core.pixels import maybe_dequantize
from sasvqa_torch.core.profiling import span
from sasvqa_torch.models.blip import (BLIPTextConfig, BLIPTextEncoder,
                                      BLIPVisionConfig, BLIPVisionEncoder)
from sasvqa_torch.models.clip import (CLIPTextConfig, CLIPTextEncoder,
                                      CLIPVisionConfig, CLIPVisionEncoder)
from sasvqa_torch.models.fusion import AnswerClassifier
from sasvqa_torch.models.layers import init_params


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        loss_type: str = "ce") -> torch.Tensor:
    """ce (labels of -100 ignored) / bce (mean times num_labels) / mse."""
    if loss_type == "ce":
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
        return (nll * valid).sum() / valid.sum().clamp(min=1)
    if loss_type == "bce":
        labels = labels.float()
        per = -(labels * F.logsigmoid(logits)
                + (1 - labels) * F.logsigmoid(-logits))
        return per.mean() * logits.shape[1]
    if loss_type == "mse":
        return torch.mean((logits.reshape(-1) - labels.reshape(-1)) ** 2)
    raise ValueError(f"unknown loss_type {loss_type}")


@dataclasses.dataclass(frozen=True)
class ClassifierHeadConfig:
    num_labels: int = 1000
    loss_type: str = "ce"
    classifier: str = "linear"
    cls_hidden_scale: int = 2
    hidden_dropout_prob: float = 0.1
    attn_type: str = "dec-only"  # reference variants: enc-dec, dec-cas


def _dropout_generator(deterministic: bool,
                       generator: Optional[torch.Generator]):
    if not deterministic and generator is None:
        raise ValueError("deterministic=False needs a dropout generator")
    return None if deterministic else generator


def _heads(module: nn.Module, d_model: int, vis_size: int,
           head: ClassifierHeadConfig, multiple_choice: bool,
           dtype: torch.dtype, gen: torch.Generator) -> None:
    """The model's one head, initialised from ``gen``.  The JAX package
    declares both heads but initialises only the one its init method
    runs: ``answer_head`` (the config's classifier settings) for answer
    classification, ``mc_head`` (one score an option row, the
    AnswerClassifier defaults: linear, 8 heads, dec-only; the config
    sets only its dropout) for multiple choice."""
    if multiple_choice:
        module.mc_head = AnswerClassifier(
            d_model, 1, vis_size=vis_size,
            dropout_rate=head.hidden_dropout_prob, dtype=dtype)
        init_params(module.mc_head, gen)
        return
    module.answer_head = AnswerClassifier(
        d_model, head.num_labels, vis_size=vis_size,
        dropout_rate=head.hidden_dropout_prob, classifier=head.classifier,
        cls_hidden_scale=head.cls_hidden_scale, attn_type=head.attn_type,
        dtype=dtype)
    init_params(module.answer_head, gen)


def _classify(module: nn.Module, txt_hidden, attention_mask, vis, labels,
              gen) -> Dict[str, torch.Tensor]:
    logits = module.answer_head(txt_hidden, attention_mask, vis, gen)
    out = {"logits": logits}
    if labels is not None:
        out["loss"] = classification_loss(logits, labels,
                                          module.head.loss_type)
    return out


def _score_options(module: nn.Module, txt_hidden, attention_mask, vis,
                   n_options: int, labels, gen) -> Dict[str, torch.Tensor]:
    """mc_head's (B*O, 1) scores -> logits (B, O); CE on the option
    indices ``labels`` (B,)."""
    scores = module.mc_head(txt_hidden, attention_mask, vis, gen)
    logits = scores.reshape(-1, n_options)
    out = {"logits": logits}
    if labels is not None:
        out["loss"] = classification_loss(logits, labels, "ce")
    return out


class CLIPVideoQA(nn.Module):
    """CLIP dual encoder + cross-attention fusion + answer classifier.

    The text encoder's hidden states and the per-frame projected image
    embeddings (B, T, projection_dim) meet in the fusion head.  Weights
    are drawn from ``generator`` (default: seeded with 0).
    ``multiple_choice=True`` builds the multiple-choice scorer (see
    :func:`_heads`)."""

    def __init__(self, text_config: CLIPTextConfig,
                 vision_config: CLIPVisionConfig, head: ClassifierHeadConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 multiple_choice: bool = False):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.text_config = text_config
        self.vision_config = vision_config
        self.head = head
        self.dtype = dtype
        self.txt_model = CLIPTextEncoder(text_config, dtype=dtype,
                                         generator=gen)
        self.vis_model = CLIPVisionEncoder(vision_config, dtype=dtype,
                                           with_projection=True,
                                           generator=gen)
        _heads(self, text_config.hidden_size, vision_config.projection_dim,
               head, multiple_choice, dtype, gen)

    def encode_video(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) pixels (u8-staged ones are dequantized) ->
        per-frame embeddings (B, T, projection_dim)."""
        pixel_values = maybe_dequantize(pixel_values, self.dtype)
        b, t = pixel_values.shape[:2]
        _, _, image_embeds = self.vis_model(
            pixel_values.reshape((b * t,) + tuple(pixel_values.shape[2:])))
        return image_embeds.reshape(b, t, -1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """input_ids/attention_mask (B, L); pixel_values (Bv, T, H, W, C)
        with B a multiple of Bv (the video encodes once and its frame
        embeddings repeat); labels (B,).  Returns f32 ``logits``
        (B, num_labels) and, with labels, the ``loss``.
        ``deterministic=False`` applies the head's dropout, drawn from
        ``generator`` (required then)."""
        gen = _dropout_generator(deterministic, generator)
        txt_hidden, _ = self.txt_model(input_ids, attention_mask)
        vis = self.encode_video(pixel_values)
        if vis.shape[0] != input_ids.shape[0]:
            vis = vis.repeat_interleave(input_ids.shape[0] // vis.shape[0],
                                        dim=0)
        return _classify(self, txt_hidden, attention_mask, vis, labels, gen)

    def multiple_choice(self, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        pixel_values: torch.Tensor, n_options: int,
                        labels: Optional[torch.Tensor] = None,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        """TGIF-QA action/transition scoring: input_ids/attention_mask
        (B*O, L) question+option rows, pixel_values (B, T, H, W, C),
        labels (B,) option indices.  The video encodes once and its frame
        embeddings repeat over the O rows.  Returns f32 ``logits`` (B, O)
        and, with labels, the CE ``loss``."""
        gen = _dropout_generator(deterministic, generator)
        txt_hidden, _ = self.txt_model(input_ids, attention_mask)
        vis = self.encode_video(pixel_values).repeat_interleave(n_options,
                                                                dim=0)
        return _score_options(self, txt_hidden, attention_mask, vis,
                              n_options, labels, gen)


class BLIPVideoQA(nn.Module):
    """BLIP vision + multimodal text encoder + fusion classifier.

    The text encoder cross-attends to the flattened (B, T*P, D) frame
    tokens; the fusion head reads the per-frame pooled CLS embeddings.
    A forward run eagerly records the spans ``model.vision``,
    ``model.text`` and ``model.head`` (:mod:`core.profiling`; a replayed
    CUDA graph runs no Python, so records none).
    Weights are drawn from ``generator`` (default: seeded with 0).
    ``multiple_choice=True`` builds the multiple-choice scorer (see
    :func:`_heads`)."""

    def __init__(self, text_config: BLIPTextConfig,
                 vision_config: BLIPVisionConfig, head: ClassifierHeadConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 multiple_choice: bool = False):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.text_config = text_config
        self.vision_config = vision_config
        self.head = head
        self.dtype = dtype
        self.txt_model = BLIPTextEncoder(text_config, dtype=dtype,
                                         generator=gen)
        self.vis_model = BLIPVisionEncoder(vision_config, dtype=dtype,
                                           generator=gen)
        _heads(self, text_config.hidden_size, vision_config.hidden_size,
               head, multiple_choice, dtype, gen)

    def _encode(self, input_ids, attention_mask, pixel_values, repeat, gen):
        """Text hidden states cross-attending to the frame tokens, and the
        pooled frame embeddings, both repeated ``repeat`` times a video."""
        with span("model.vision"):
            pixel_values = maybe_dequantize(pixel_values, self.dtype)
            b, t = pixel_values.shape[:2]
            vis_hidden, vis_pooled = self.vis_model(pixel_values.reshape(
                (b * t,) + tuple(pixel_values.shape[2:])))
            p, d = vis_hidden.shape[-2:]
            enc_hidden = vis_hidden.reshape(b, t * p, d)
            vis = vis_pooled.reshape(b, t, -1)
            if repeat > 1:
                enc_hidden = enc_hidden.repeat_interleave(repeat, dim=0)
                vis = vis.repeat_interleave(repeat, dim=0)
        with span("model.text"):
            txt_hidden, _ = self.txt_model(input_ids, attention_mask,
                                           encoder_hidden=enc_hidden,
                                           generator=gen)
        return txt_hidden, vis

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """input_ids/attention_mask (B, L); pixel_values (Bv, T, H, W, C)
        with B a multiple of Bv (u8-staged pixels are dequantized);
        labels (B,).  Returns f32 ``logits`` (B, num_labels) and, with
        labels, the ``loss``.  ``deterministic=False`` applies the
        dropouts, drawn from ``generator`` (required then)."""
        gen = _dropout_generator(deterministic, generator)
        txt_hidden, vis = self._encode(
            input_ids, attention_mask, pixel_values,
            input_ids.shape[0] // pixel_values.shape[0], gen)
        with span("model.head"):
            return _classify(self, txt_hidden, attention_mask, vis, labels,
                             gen)

    def multiple_choice(self, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        pixel_values: torch.Tensor, n_options: int,
                        labels: Optional[torch.Tensor] = None,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        """TGIF-QA action/transition scoring (see
        :meth:`CLIPVideoQA.multiple_choice`): the frame tokens the text
        encoder cross-attends to and the pooled frame embeddings both
        repeat over the O option rows of their video."""
        gen = _dropout_generator(deterministic, generator)
        txt_hidden, vis = self._encode(input_ids, attention_mask,
                                       pixel_values, n_options, gen)
        with span("model.head"):
            return _score_options(self, txt_hidden, attention_mask, vis,
                                  n_options, labels, gen)
