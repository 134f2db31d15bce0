"""GIT (GenerativeImage2Text) causal LM for video QA.

Counterpart of sasvqa_tpu/models/git.py:

- all B*T frames go through the vision tower as one batch and reshape to
  a (B, T*P, D) visual prefix;
- the prompt-fill pass caches per-layer image K/V once (image tokens
  attend only image tokens, so their K/V do not depend on the text) and
  each decode step processes one token against a split image/text cache;
- prompts are right-padded with per-example lengths.

The 6-layer text stack attends under the GIT mask.  Long sequences on
the GPU (image + text >= 512 tokens, 3 or more frames of 197 tokens) go
through the hand-written kernel in ops/git_flash.py; shorter ones, and
the CPU, take the dense additive-bias path, as ``_use_git_flash`` decides
in the JAX package.  ``flash=True/False`` forces the route (on the CPU
the git-flash route runs the kernels' plain versions).

The training forward (``deterministic=False``) applies the embedding,
attention-output and FFN dropouts and the attention-probability dropout,
all drawn from an explicit ``torch.Generator``; the git-flash route
regenerates the attention mask in its kernels from a per-layer seed, the
dense route applies the same hash mask densely.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.pixels import host_tensor, maybe_dequantize
from sasvqa_torch.core.profiling import span
from sasvqa_torch.models.clip import CLIPVisionConfig, CLIPVisionEncoder
from sasvqa_torch.models.layers import (BertFFN, Dense, Dropout, Embed,
                                        LayerNorm, init_params, merge_heads,
                                        split_heads)
from sasvqa_torch.ops.attention import NEG_INF, dot_product_attention
from sasvqa_torch.ops.git_flash import (dense_attention_with_hash_dropout,
                                        git_flash_attention)

_GIT_FLASH_MIN_SEQ = 512


@dataclasses.dataclass(frozen=True)
class GITConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    # dropout rates of the training forward: hidden (embeddings, attention
    # output, FFN) and attention probabilities (HF GitSelfAttention)
    dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    cls_token_id: int = 101
    sep_token_id: int = 102  # doubles as EOS for generation
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=lambda: CLIPVisionConfig(patch_size=16))

    @property
    def tokens_per_frame(self) -> int:
        return (self.vision.image_size // self.vision.patch_size) ** 2 + 1


GIT_BASE = GITConfig()


class GitAttention(nn.Module):
    """BERT-style attention with a fused QKV projection and the K/V
    exposed for decode caching."""

    def __init__(self, hidden_size: int, num_heads: int,
                 layer_norm_eps: float, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_dropout_rate = attn_dropout_rate
        self.qkv = Dense(hidden_size, 3 * hidden_size, dtype=dtype)
        self.out_dense = Dense(hidden_size, hidden_size, dtype=dtype)
        self.out_ln = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.drop = Dropout(dropout_rate)

    def project(self, hidden: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        q, k, v = self.qkv(hidden).chunk(3, dim=-1)
        return (split_heads(q, self.num_heads),
                split_heads(k, self.num_heads),
                split_heads(v, self.num_heads))

    def finish(self, hidden: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, bias: Optional[torch.Tensor],
               use_flash: Optional[bool] = None,
               git_mask: Optional[Tuple[int, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # attention-probability dropout: a per-(layer, step) int32 seed
        # drawn from the dropout generator; the coordinate hash
        # decorrelates (b, h, row, col).  The seed stays on the device.
        drop_on = self.attn_dropout_rate > 0.0 and generator is not None
        seed = None
        if drop_on:
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator,
                                 device=hidden.device,
                                 dtype=torch.int64).to(torch.int32)
        if git_mask is not None:
            num_img, attention_mask = git_mask
            out, _ = git_flash_attention(
                q, k, v, attention_mask, num_img,
                rate=self.attn_dropout_rate if drop_on else 0.0, seed=seed)
        elif drop_on:
            out = dense_attention_with_hash_dropout(
                q, k, v, bias, seed, self.attn_dropout_rate)
        else:
            out = dot_product_attention(q, k, v, bias=bias,
                                        use_flash=use_flash)
        return self.finish_from_ctx(hidden, merge_heads(out), generator)

    def finish_from_ctx(self, hidden: torch.Tensor, ctx: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Output projection (+ dropout) + residual LN for a context
        computed by the caller (the decode step attends over the split
        cache itself)."""
        return self.out_ln(hidden + self.drop(self.out_dense(ctx), generator))

    def forward(self, hidden, bias=None, use_flash=None, generator=None):
        q, k, v = self.project(hidden)
        return self.finish(hidden, q, k, v, bias, use_flash,
                           generator=generator)


class GitLayer(nn.Module):
    def __init__(self, config: GITConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.attention = GitAttention(c.hidden_size, c.num_heads,
                                      c.layer_norm_eps, dtype, c.dropout,
                                      c.attention_dropout)
        self.ffn = BertFFN(c.hidden_size, c.intermediate_size, c.hidden_act,
                           c.layer_norm_eps, dtype, c.dropout)

    def forward(self, x, bias=None, use_flash=None, git_mask=None,
                generator=None):
        return self.full_with_kv(x, bias, use_flash, git_mask, generator)[0]

    def full_with_kv(self, x, bias=None, use_flash=None, git_mask=None,
                     generator=None):
        """Forward pass that also returns this layer's K/V (for building
        decode caches during prompt fill).  ``generator`` turns the
        dropouts on."""
        q, k, v = self.attention.project(x)
        h = self.attention.finish(x, q, k, v, bias, use_flash,
                                  git_mask=git_mask, generator=generator)
        return self.ffn(h, generator), (k, v)


def git_attention_bias(num_img: int, attention_mask: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The GIT combined mask as a (B, 1, M+L, M+L) additive bias:

    - image rows attend to image columns only;
    - text rows attend to all image columns + causal text columns,
      additionally masked by the text padding mask.
    """
    b, l = attention_mask.shape
    m = num_img
    s = m + l
    dev = attention_mask.device
    idx = torch.arange(s, device=dev)
    is_text_row = (idx >= m)[:, None]
    is_text_col = (idx >= m)[None, :]
    causal_ok = idx[None, :] <= idx[:, None]
    ok = torch.where(is_text_row, torch.where(is_text_col, causal_ok, True),
                     ~is_text_col)
    zero = torch.zeros((), device=dev)
    base = torch.where(ok, zero, zero + NEG_INF)[None, None]   # (1,1,S,S)
    # text-key padding applies to text rows x text cols
    pad = (1.0 - attention_mask.float()) * NEG_INF             # (B, L)
    pad_cols = torch.cat([torch.zeros((b, m), device=dev), pad],
                         dim=1)[:, None, None, :]              # (B,1,1,S)
    pad_bias = torch.where(is_text_row[None, None], pad_cols, zero)
    return (base + pad_bias).to(dtype)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
                 idx: torch.Tensor, inside: torch.Tensor) -> None:
    """``buf[b, :, idx[b]] = new[b, :, 0]`` where ``inside[b]``, in place.

    The JAX package blends a one-hot mask into a new buffer each step;
    this writes the one slot per row in place instead.  Rows whose
    position has run past the buffer keep their old value, as the
    one-hot (all zeros there) leaves it."""
    old = buf[rows, :, idx]                                    # (B, H, Dh)
    buf[rows, :, idx] = torch.where(inside[:, None, None], new[:, :, 0], old)


class GITForCausalLM(nn.Module):
    """GIT causal LM over a [visual prefix; text] sequence.

    ``flash``: None = auto (the git-flash kernel on CUDA tensors when the
    combined sequence reaches 512 tokens), True = the git-flash route,
    False = the dense additive-bias route.  ``remat``/``remat_policy``
    go to the vision tower (:class:`CLIPVisionEncoder`).  Weights are
    drawn from ``generator`` (default: seeded with 0)."""

    def __init__(self, config: GITConfig, dtype: torch.dtype = torch.float32,
                 flash: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.flash = flash
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.image_encoder = CLIPVisionEncoder(
            c.vision, dtype=dtype, post_ln_all_tokens=True,
            with_projection=False, generator=gen, remat=remat,
            remat_policy=remat_policy)
        self.visual_projection = Dense(c.vision.hidden_size, c.hidden_size,
                                       dtype=dtype)
        self.visual_projection_ln = LayerNorm(
            c.hidden_size, c.vision.layer_norm_eps, dtype)
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings,
                                         c.hidden_size, dtype)
        self.emb_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.emb_drop = Dropout(c.dropout)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", GitLayer(c, dtype))
        self.output = Dense(c.hidden_size, c.vocab_size, dtype=dtype)
        for name, child in self.named_children():
            if name != "image_encoder":   # drew its own weights above
                init_params(child, gen)

    @property
    def layers(self) -> List[GitLayer]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def _use_git_flash(self, seq_len: int, device: torch.device) -> bool:
        if self.flash is not None:
            return self.flash
        return seq_len >= _GIT_FLASH_MIN_SEQ and device.type == "cuda"

    def _attention_route(self, m: int, attention_mask: torch.Tensor
                         ) -> Dict[str, Any]:
        """Attention arguments of the text-stack layers: the git-flash
        route, or the dense additive-bias route.  ``flash=False`` runs the
        dense route with plain attention at any length, the oracle the
        git-flash route is checked against (the JAX package would send a
        long dense route to its generic flash kernel)."""
        if self._use_git_flash(m + attention_mask.shape[1],
                               attention_mask.device):
            return {"bias": None, "git_mask": (m, attention_mask)}
        return {"bias": git_attention_bias(m, attention_mask, self.dtype),
                "git_mask": None,
                "use_flash": False if self.flash is False else None}

    # ---- shared pieces -------------------------------------------------

    def encode_frames(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> projected visual prefix (B, T*P, D); accepts
        u8-staged pixels (core/pixels wire format)."""
        pixel_values = maybe_dequantize(pixel_values, self.dtype)
        b, t = pixel_values.shape[:2]
        flat = pixel_values.reshape((b * t,) + tuple(pixel_values.shape[2:]))
        feats, _, _ = self.image_encoder(flat)          # (B*T, P, Dv)
        p, dv = feats.shape[-2:]
        feats = feats.reshape(b, t * p, dv)
        return self.visual_projection_ln(self.visual_projection(feats))

    def embed_text(self, input_ids: torch.Tensor, positions: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings(positions)
        return self.emb_drop(self.emb_ln(x), generator)

    def _visual_prefix(self, pixel_values: torch.Tensor,
                       b: int) -> torch.Tensor:
        vis = self.encode_frames(pixel_values)
        # groups with >1 example share one video: repeat the encoded
        # prefix (the ViT runs once per video)
        if vis.shape[0] != b:
            vis = vis.repeat_interleave(b // vis.shape[0], dim=0)
        return vis

    # ---- scoring forward -----------------------------------------------

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Training/scoring forward.  input_ids/attention_mask: (B, L);
        pixel_values: (B, T, H, W, C); labels: (B, L) with -100 ignored.
        Returns ``logits`` (B, M+L, V) f32, or with labels the text-only
        ``logits_text`` (B, L-1, V) and the shifted CE ``loss``.
        ``deterministic=False`` applies every dropout, drawn from
        ``generator`` (required then, on the inputs' device)."""
        if not deterministic and generator is None:
            raise ValueError("deterministic=False needs a dropout generator")
        gen = None if deterministic else generator
        b, l = input_ids.shape
        vis = self._visual_prefix(pixel_values, b)
        m = vis.shape[1]
        pos = torch.arange(l, device=input_ids.device)[None, :]
        h = torch.cat([vis, self.embed_text(input_ids, pos, gen)], dim=1)
        route = self._attention_route(m, attention_mask)
        for lyr in self.layers:
            h = lyr(h, generator=gen, **route)
        if labels is None:
            return {"logits": self.output(h).float()}
        # the loss reads only text-position logits shifted past the
        # image prefix, so only those are projected onto the vocabulary
        shifted = self.output(h[:, m:-1, :]).float()
        tgt = labels[:, 1:].long()
        valid = tgt != -100
        tgt_safe = torch.where(valid, tgt, torch.zeros_like(tgt))
        logp = torch.log_softmax(shifted, dim=-1)
        nll = -torch.gather(logp, -1, tgt_safe[..., None])[..., 0]
        loss = (nll * valid).sum() / valid.sum().clamp(min=1)
        return {"logits_text": shifted, "loss": loss}

    # ---- generation -----------------------------------------------------

    def prompt_fill(self, input_ids: torch.Tensor, prompt_len: torch.Tensor,
                    pixel_values: torch.Tensor, max_text_len: int
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process image + right-padded prompt; build decode caches.

        input_ids: (B, Lp) right-padded prompts; prompt_len: (B,) actual
        lengths.  Returns (first generated token logits (B, V) f32,
        cache).  The text K/V cache is sized to ``max_text_len``."""
        b, lp = input_ids.shape
        if lp > max_text_len:
            raise ValueError(f"prompt width {lp} exceeds the decode budget "
                             f"{max_text_len}")
        dev = input_ids.device
        attention_mask = (torch.arange(lp, device=dev)[None, :]
                          < prompt_len[:, None]).to(torch.int32)
        vis = self._visual_prefix(pixel_values, b)
        m = vis.shape[1]
        pos = torch.arange(lp, device=dev)[None, :]
        h = torch.cat([vis, self.embed_text(input_ids, pos)], dim=1)
        route = self._attention_route(m, attention_mask)

        img_kv, txt_kv = [], []
        for lyr in self.layers:
            h, (k, v) = lyr.full_with_kv(h, **route)
            img_kv.append((k[:, :, :m].contiguous(), v[:, :, :m].contiguous()))
            kt = k.new_zeros(k.shape[:2] + (max_text_len, k.shape[3]))
            vt = v.new_zeros(kt.shape)
            kt[:, :, :lp] = k[:, :, m:]
            vt[:, :, :lp] = v[:, :, m:]
            txt_kv.append((kt, vt))
        # only each prompt's last-token hidden state is read; batch-padding
        # rows (prompt_len=0) read position 0
        last_pos = (prompt_len.long() - 1).clamp(min=0)
        h_last = h[:, m:][torch.arange(b, device=dev), last_pos]  # (B, D)
        last = self.output(h_last).float()
        cache = {"img_kv": img_kv, "txt_kv": txt_kv, "cur_len": prompt_len}
        return last, cache

    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One greedy-decode step: token (B,) -> (next logits (B, V) f32,
        cache).  The text K/V buffers are updated in place."""
        b = token.shape[0]
        dev = token.device
        cur = cache["cur_len"]                           # (B,)
        max_len = cache["txt_kv"][0][0].shape[2]
        h = self.embed_text(token[:, None], cur[:, None])  # (B, 1, D)

        slots = torch.arange(max_len, device=dev)[None, :]
        zero = torch.zeros((), device=dev)
        # text columns valid up to and including the new token
        txt_bias = torch.where(slots <= cur[:, None], zero,
                               zero + NEG_INF)[:, None, None, :]
        rows = torch.arange(b, device=dev)
        idx = cur.long().clamp(max=max_len - 1)
        inside = cur < max_len

        for i, lyr in enumerate(self.layers):
            k_img, v_img = cache["img_kv"][i]
            k_txt, v_txt = cache["txt_kv"][i]
            q, k_new, v_new = lyr.attention.project(h)   # (B, H, 1, Dh)
            _cache_write(k_txt, k_new, rows, idx, inside)
            _cache_write(v_txt, v_new, rows, idx, inside)
            # split-cache attention: score the image and text caches in
            # place and concatenate only the (B, H, 1, M+maxlen) scores;
            # f32 scores/softmax, probs in the activation dtype, f32 sums
            scale = q.shape[-1] ** -0.5
            qf = q.float()
            s_img = torch.matmul(qf, k_img.float().transpose(-1, -2)) * scale
            s_txt = torch.matmul(qf, k_txt.float().transpose(-1, -2)) * scale
            m = k_img.shape[2]
            probs = torch.softmax(torch.cat([s_img, s_txt + txt_bias], -1),
                                  dim=-1).to(q.dtype).float()
            ctx = (torch.matmul(probs[..., :m], v_img.float())
                   + torch.matmul(probs[..., m:], v_txt.float())).to(q.dtype)
            h = lyr.attention.finish_from_ctx(h, merge_heads(ctx))
            h = lyr.ffn(h)
        logits = self.output(h)[:, 0].float()             # (B, V)
        return logits, dict(cache, cur_len=cur + 1)


def _on_device(x, device: torch.device, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    return host_tensor(x).to(device=device, dtype=dtype)


@torch.inference_mode()
def greedy_generate(model: GITForCausalLM, input_ids, prompt_len,
                    pixel_values, max_text_len: int = 50,
                    max_new_tokens: Optional[int] = None,
                    device: DeviceLike = "cuda",
                    all_done: Optional[Callable[[torch.Tensor], bool]] = None
                    ) -> torch.Tensor:
    """Greedy decoding to ``max_text_len`` total text tokens per example.

    Each example stops at [SEP] or when its own text length (prompt +
    generated) reaches ``max_text_len``; finished rows emit pad.  Returns
    (B, max_new) generated token ids.  The loop exits as soon as every
    row is finished; that check reads one flag from the device per
    token (``all_done(done)`` decides instead when given: ranks whose
    forward communicates exit together).  Inputs may be numpy arrays or
    tensors; they are moved to ``device``."""
    dev = resolve_device(device)
    eos = model.config.sep_token_id
    pad = model.config.pad_token_id
    max_new = max_text_len - 1 if max_new_tokens is None else max_new_tokens
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    with span("model.prompt_fill"):
        input_ids = _on_device(input_ids, dev, torch.long)
        prompt_len = _on_device(prompt_len, dev, torch.long)
        pixel_values = _on_device(pixel_values, dev)
        logits, cache = model.prompt_fill(input_ids, prompt_len,
                                          pixel_values, max_text_len)
        first = logits.argmax(dim=-1)
        over0 = prompt_len >= max_text_len     # no room for any new token
        # batch-padding rows (prompt_len == 0) are born done
        done = (first == eos) | over0 | (prompt_len == 0)
        tok = torch.where(done, torch.full_like(first, pad), first)
        buf = torch.full((input_ids.shape[0], max_new), pad,
                         dtype=torch.long, device=dev)
        buf[:, 0] = tok
    for i in range(1, max_new):
        # a step's span opens with the read of the flag, which waits for
        # the step before it
        with span("model.decode_step"):
            if all_done(done) if all_done is not None else bool(done.all()):
                break
            logits, cache = model.decode_step(tok, cache)
            nxt = logits.argmax(dim=-1)
            # position of nxt in the text sequence == the updated cur_len
            over = cache["cur_len"] >= max_text_len
            nxt = torch.where(done | over, torch.full_like(nxt, pad), nxt)
            done = done | over | (nxt == eos)
            nxt = torch.where(nxt == eos, torch.full_like(nxt, pad), nxt)
            buf[:, i] = nxt
            tok = nxt
    return buf
