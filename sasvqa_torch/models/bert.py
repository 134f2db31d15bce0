"""BERT encoder with a sequence-classification head (counterpart of
sasvqa_tpu/models/bert.py).

Stage B's question-aware frame scorer: an HF
``BertForSequenceClassification`` (the reference's default is
``iarfmoose/bert-base-cased-qa-evaluator``) scores (question, caption)
pairs by ``logits[:, 0]``.  Attention takes the plain path: the scorer's
64 tokens are below the flash route's length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from sasvqa_torch.models.layers import (Dense, Dropout, Embed, LayerNorm,
                                        PostLNBlock, init_params)
from sasvqa_torch.ops.attention import padding_bias


@dataclasses.dataclass(frozen=True)
class BERTConfig:
    vocab_size: int = 28996          # bert-base-cased
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    dropout: float = 0.1
    num_labels: int = 2


class BERTForSequenceClassification(nn.Module):
    """Embeddings (word + position + token type, LN), post-LN encoder
    layers under a padding bias, tanh pooler of the first token, linear
    classifier; f32 logits.  Weights are drawn from ``generator``
    (default: seeded with 0)."""

    def __init__(self, config: BERTConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings,
                                         c.hidden_size, dtype)
        self.token_type_embeddings = Embed(c.type_vocab_size, c.hidden_size,
                                           dtype)
        self.emb_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.drop = Dropout(c.dropout)
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", PostLNBlock(
                c.hidden_size, c.num_heads, c.intermediate_size,
                c.hidden_act, c.layer_norm_eps, c.dropout, dtype=dtype))
        self.pooler = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        self.classifier = Dense(c.hidden_size, c.num_labels, dtype=dtype)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """input_ids/attention_mask/token_type_ids (B, L) -> logits
        (B, num_labels) f32.  Dropout applies only with a ``generator``.
        A text longer than ``max_position_embeddings`` raises."""
        c = self.config
        b, l = input_ids.shape
        if l > c.max_position_embeddings:
            raise ValueError(
                f"text length {l} exceeds max_position_embeddings "
                f"{c.max_position_embeddings}; lower --score_max_length")
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(l, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids.long()))
        x = self.drop(self.emb_ln(x), generator)
        bias = padding_bias(attention_mask, dtype=self.dtype)
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x, bias=bias,
                                             generator=generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        pooled = self.drop(pooled, generator)
        return self.classifier(pooled).float()


def convert_bert_classifier(sd: Dict[str, Any],
                            num_layers: int) -> Dict[str, Any]:
    """HF ``BertForSequenceClassification`` state dict -> the Flax
    layout of :class:`BERTForSequenceClassification` (for
    ``convert.merge_pretrained``)."""
    from sasvqa_torch.models.convert import _bert_attention, _emb, _lin, _ln
    params = {
        "word_embeddings": _emb(sd, "bert.embeddings.word_embeddings"),
        "position_embeddings": _emb(
            sd, "bert.embeddings.position_embeddings"),
        "token_type_embeddings": _emb(
            sd, "bert.embeddings.token_type_embeddings"),
        "emb_ln": _ln(sd, "bert.embeddings.LayerNorm"),
        "pooler": _lin(sd, "bert.pooler.dense"),
        "classifier": _lin(sd, "classifier"),
    }
    for i in range(num_layers):
        p = f"bert.encoder.layer.{i}"
        params[f"layers_{i}"] = {
            "attention": _bert_attention(sd, f"{p}.attention"),
            "ffn": {
                "intermediate": _lin(sd, f"{p}.intermediate.dense"),
                "output": _lin(sd, f"{p}.output.dense"),
                "ln": _ln(sd, f"{p}.output.LayerNorm"),
            },
        }
    return params
