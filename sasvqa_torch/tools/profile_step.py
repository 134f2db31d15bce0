"""Train-step decomposition of the flagship GIT-base update (counterpart
of sasvqa_tpu/tools/profile_step.py):

    python3 -m sasvqa_torch.tools.profile_step [--iters 8]
        [--probe step --probe txt_flash ...] [--platform cpu]

Times each compute component of the bench's train step (B=16, 8 frames of
224x224, text length 32, S = 8*197 + 32 = 1608; seeded random weights,
bf16 activations, f32 params) on its own, so that work on speed targets
the largest bucket.  Each probe runs once to warm up, then ``--iters``
times back to back, timed by CUDA events and ending in a synchronize
(the host clock on the CPU).  Probes (forward + backward where marked):

  step       one AdamW update of GIT-base through ``make_git_train_step``
             (the training forward: dropout 0.1, attention dropout 0.1)
  vis_tower  the vision tower on B*T frames                 (fwd+bwd)
  vis_attn   12 vision attentions at 197 tokens, chained    (fwd+bwd, q/k/v)
  txt_flash  6 git-flash attentions at S, chained, attention dropout 0.1
             as in training                                 (fwd+bwd, q/k/v)
  txt_stack  6 GIT text layers at S under the GIT mask      (fwd+bwd, +params)
  logits     vocabulary projection + CE on text positions   (fwd+bwd)
  adamw      the optimizer update alone (GIT-base's parameters)
  embed      word-embedding gather + position add           (fwd+bwd)
  mm_768     two chained GEMMs at K=768 (B*S x 768 x 3072)

Every backward probe carries all of its gradients (a probe of dQ alone
would leave dK/dV unused).  Each probe prints one JSON line: ms, the
operations it needs (TFLOP, from the shapes), TFLOP/s and, on the GPU,
the share of the card's dense bf16 peak and the peak memory.  On the GPU
``txt_flash``, ``txt_stack`` and ``step`` run the git-flash kernels (K1,
K2; K4 in ``txt_flash`` and ``step``).  Runs on the GPU unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.models.clip import CLIPVisionEncoder
from sasvqa_torch.models.git import (_GIT_FLASH_MIN_SEQ, GITConfig, GitLayer,
                                     git_attention_bias)
from sasvqa_torch.models.presets import _git_config, build_model
from sasvqa_torch.ops.attention import dot_product_attention
from sasvqa_torch.ops.git_flash import git_flash_attention
from sasvqa_torch.train.steps import (create_train_state, make_git_train_step,
                                      make_optimizer)

# one H100 SXM's dense bf16 peak and memory rate (NVIDIA data sheet, at
# its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# the shipped msvd_qa_base optimizer groups (betas 0.9/0.98, weight decay
# 1e-3, grad_norm 5)
OPTIM = {"optim": "adamw", "learning_rate": 2e-4, "betas": [0.9, 0.98],
         "weight_decay": 1e-3, "grad_norm": 5.0, "decay": "constant"}


@dataclasses.dataclass(frozen=True)
class GitShape:
    """A GIT training shape: the preset ``model`` (a build_model name),
    B questions over ``frames`` frames, text length ``text_len``, the
    vision tower's remat and its named policy."""
    model: str
    batch: int
    frames: int
    text_len: int
    remat: bool = False
    remat_policy: Optional[str] = None

    def cfg(self) -> Dict[str, Any]:
        return {"model": {"pretrained_model": self.model},
                "remat": self.remat, "remat_policy": self.remat_policy}

    @property
    def git(self) -> GITConfig:
        return _git_config(self.model.lower())

    @property
    def num_img(self) -> int:
        return self.frames * self.git.tokens_per_frame

    @property
    def seq(self) -> int:
        return self.num_img + self.text_len


FLAGSHIP = GitShape("microsoft/git-base-msrvtt-qa", batch=16, frames=8,
                    text_len=32)


# ---- operations the work needs (matmul FLOP, from the shapes) -----------

def vis_fwd_flop(s: GitShape) -> float:
    """Projection and MLP matmuls of the vision tower's forward."""
    v = s.git.vision
    tokens = s.batch * s.frames * s.git.tokens_per_frame
    return (tokens * v.num_layers * 2
            * (4 * v.hidden_size ** 2 + 2 * v.hidden_size
               * v.intermediate_size))


def vis_attn_fwd_flop(s: GitShape) -> float:
    v = s.git.vision
    p = s.git.tokens_per_frame
    return (v.num_layers * 4 * s.batch * s.frames * v.num_heads * p * p
            * (v.hidden_size // v.num_heads))


def txt_fwd_flop(s: GitShape) -> float:
    c = s.git
    return (c.num_layers * 2 * s.batch * s.seq
            * (4 * c.hidden_size ** 2
               + 2 * c.hidden_size * c.intermediate_size))


def flash_fwd_flop(s: GitShape) -> float:
    """Both attention products over the full S x S square (the JAX tool's
    count; the GIT mask leaves the text block's upper triangle out)."""
    c = s.git
    return c.num_layers * 4 * s.batch * c.hidden_size * s.seq * s.seq


def logits_fwd_flop(s: GitShape) -> float:
    c = s.git
    return 2 * s.batch * (s.text_len - 1) * c.hidden_size * c.vocab_size


def step_flop(s: GitShape) -> float:
    """Model FLOP of one update: 3x the forward's matmuls (no remat
    recompute counted), the flash backward at 2.5x its forward."""
    return (3 * (vis_fwd_flop(s) + vis_attn_fwd_flop(s) + txt_fwd_flop(s)
                 + logits_fwd_flop(s)) + 3.5 * flash_fwd_flop(s))


# ---- timing ---------------------------------------------------------------

def timed(fn: Callable[[], Any], iters: int, device: torch.device,
          warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls after
    ``warmup`` calls: CUDA events ending in a synchronize on the GPU, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def measure(name: str, build: Callable[[], Tuple[Callable[[], Any],
                                                  Optional[float]]],
            iters: int, device: torch.device, **extra) -> Dict[str, Any]:
    """Build a probe (``build() -> (fn, flop or None[, info dict])``),
    time it, and return its row: ms, TFLOP and TFLOP/s, the info, and on
    the GPU the share of the dense bf16 peak and the peak memory of the
    build and the run."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    fn, flop, *info = build()
    ms = timed(fn, iters, device)
    row: Dict[str, Any] = {"probe": name, "device": str(device),
                           "iters": iters, "ms": ms, **extra, **dict(*info)}
    if flop:
        row.update(tflop=flop / 1e12, tflops=flop / ms / 1e9)
    if device.type == "cuda":
        if flop:
            row["peak_share"] = flop / (ms / 1e3) / PEAK_BF16_FLOPS
        row["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated(device) / 2 ** 30
    del fn
    return row


def _sgd(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]):
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(1e-6 * g)


def _leaf(x: np.ndarray, dev: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(device=dev, dtype=dtype).requires_grad_()


def git_batch(s: GitShape, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A device-resident batch of ``s``: ids and labels from seed 0, half
    the label positions ignored, frames of seeded normal pixels."""
    rng = np.random.default_rng(0)
    v = s.git.vision
    ids = rng.integers(1, min(1000, s.git.vocab_size), (s.batch, s.text_len))
    labels = np.where(rng.random((s.batch, s.text_len)) < 0.5, ids, -100)
    px = rng.standard_normal((s.batch, s.frames, v.image_size,
                              v.image_size, 3), dtype=np.float32)
    return {"text_input_ids": torch.from_numpy(ids).long().to(dev),
            "text_attention_mask": torch.ones(s.batch, s.text_len,
                                              dtype=torch.int32, device=dev),
            "visual_inputs": torch.from_numpy(px).to(dev),
            "labels": torch.from_numpy(labels).long().to(dev)}


# ---- probes: each returns (fn, FLOP or None) -----------------------------

def git_update(s: GitShape, dev: torch.device):
    """GIT at ``s`` with weights from seed 0, its AdamW train state and a
    batch: ``update()`` runs one update through ``make_git_train_step``
    (the training forward with every dropout, drawn from seed 0 at every
    update) and returns its loss; the parameters' ``.grad`` then hold that
    update's gradients."""
    _, model = build_model(s.cfg(), dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, OPTIM, total_steps=1000, device=dev)
    step = make_git_train_step(dev)
    batch = git_batch(s, dev)

    def update():
        nonlocal state
        state, metrics = step(state, batch, 0)
        return metrics["loss"]

    return model, update


def probe_step(s: GitShape, dev: torch.device):
    _, update = git_update(s, dev)
    return update, step_flop(s)


def probe_vis_tower(s: GitShape, dev: torch.device):
    enc = CLIPVisionEncoder(s.git.vision, dtype=torch.bfloat16,
                            post_ln_all_tokens=True, with_projection=False,
                            remat=s.remat, remat_policy=s.remat_policy
                            ).to(dev).train()
    params = list(enc.parameters())
    flat = git_batch(s, dev)["visual_inputs"].flatten(0, 1)

    def fn():
        feats, _, _ = enc(flat)
        grads = torch.autograd.grad((feats.float() ** 2).mean(), params)
        _sgd(params, grads)

    return fn, 3 * vis_fwd_flop(s)


def probe_vis_attn(s: GitShape, dev: torch.device):
    v = s.git.vision
    shape = (s.batch * s.frames, v.num_heads, s.git.tokens_per_frame,
             v.hidden_size // v.num_heads)
    rng = np.random.default_rng(0)
    qkv = [_leaf(rng.standard_normal(shape, dtype=np.float32), dev,
                 torch.bfloat16) for _ in range(3)]

    def fn():
        q, k, val = qkv
        o = q
        for _ in range(v.num_layers):
            o = dot_product_attention(o, k, val)
        _sgd(qkv, torch.autograd.grad((o.float() ** 2).mean(), qkv))

    # the stored-P dense route: forward 2 products, backward 4
    return fn, 3 * vis_attn_fwd_flop(s)


def probe_txt_flash(s: GitShape, dev: torch.device):
    c = s.git
    shape = (s.batch, c.num_heads, s.seq, c.hidden_size // c.num_heads)
    rng = np.random.default_rng(0)
    qkv = [_leaf(rng.standard_normal(shape, dtype=np.float32), dev,
                 torch.bfloat16) for _ in range(3)]
    mask = torch.ones(s.batch, s.text_len, dtype=torch.int32, device=dev)

    def fn():
        q, k, v = qkv
        o = q
        for layer in range(c.num_layers):
            o, _ = git_flash_attention(o, k, v, mask, s.num_img,
                                       c.attention_dropout, layer)
        _sgd(qkv, torch.autograd.grad((o.float() ** 2).mean(), qkv))

    # the fused backward recomputes QK^T and runs 4 gradient products
    return fn, 3.5 * flash_fwd_flop(s)


def probe_txt_stack(s: GitShape, dev: torch.device):
    c = s.git
    layer = GitLayer(c, dtype=torch.bfloat16).to(dev).train()
    params = list(layer.parameters())
    rng = np.random.default_rng(0)
    h0 = _leaf(rng.standard_normal((s.batch, s.seq, c.hidden_size),
                                   dtype=np.float32), dev, torch.bfloat16)
    mask = torch.ones(s.batch, s.text_len, dtype=torch.int32, device=dev)
    route = layer_route(s, mask)

    def fn():
        o = h0
        for _ in range(c.num_layers):
            o = layer(o, **route)
        grads = torch.autograd.grad((o.float() ** 2).mean(), [h0] + params)
        _sgd([h0] + params, grads)

    return fn, 3 * (txt_fwd_flop(s) + flash_fwd_flop(s))


def layer_route(s: GitShape, mask: torch.Tensor) -> Dict[str, Any]:
    """The text layers' attention arguments at ``s``, as
    ``GITForCausalLM`` routes them: the GIT mask (git-flash) on the GPU
    from S = 512, else the dense bias."""
    if s.seq >= _GIT_FLASH_MIN_SEQ and mask.device.type == "cuda":
        return {"git_mask": (s.num_img, mask)}
    return {"bias": git_attention_bias(s.num_img, mask, torch.bfloat16)}


def probe_logits(s: GitShape, dev: torch.device):
    c = s.git
    rng = np.random.default_rng(0)
    ht = _leaf(rng.standard_normal((s.batch, s.text_len, c.hidden_size),
                                   dtype=np.float32), dev, torch.bfloat16)
    wv = _leaf(rng.standard_normal((c.hidden_size, c.vocab_size),
                                   dtype=np.float32) * 0.02, dev,
               torch.bfloat16)
    tgt = git_batch(s, dev)["labels"][:, 1:]
    valid = tgt != -100
    safe = torch.where(valid, tgt, torch.zeros_like(tgt))

    def fn():
        logp = torch.log_softmax((ht[:, :-1] @ wv).float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        loss = (nll * valid).sum() / valid.sum().clamp(min=1)
        _sgd([ht, wv], torch.autograd.grad(loss, [ht, wv]))

    return fn, 3 * logits_fwd_flop(s)


def adamw_floor_ms(n_params: int, passes: int = 7) -> float:
    """Memory-bound floor of one f32 AdamW update at the card's memory
    rate: each parameter read as param, grad, mu, nu and written as
    param, mu, nu (5 passes with bf16 moments)."""
    return n_params * 4 * passes / PEAK_BYTES_PER_S * 1e3


def probe_adamw(s, dev: torch.device):
    """The optimizer update alone over the parameters of ``s``'s model
    (any shape with a ``cfg()``), with its memory-bound floor."""
    _, model = build_model(s.cfg(), device=dev)
    opt = make_optimizer(OPTIM, 1000, model)
    grads = [p.detach() * 1e-3 for p in opt.params]
    n = sum(p.numel() for p in opt.params)
    return (lambda: opt.update(grads)), None, {
        "params": n, "floor_ms": adamw_floor_ms(n),
        "floor_ms_bf16_moments": adamw_floor_ms(n, 5)}


def probe_embed(s: GitShape, dev: torch.device):
    c = s.git
    rng = np.random.default_rng(0)
    table = _leaf(rng.standard_normal((c.vocab_size, c.hidden_size),
                                      dtype=np.float32), dev,
                  torch.bfloat16)
    ids = git_batch(s, dev)["text_input_ids"]

    def fn():
        x = table[ids] + table[:s.text_len]
        _sgd([table], torch.autograd.grad((x.float() ** 2).mean(),
                                          [table]))

    return fn, None


def probe_mm_768(s: GitShape, dev: torch.device):
    c = s.git
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (s.batch * s.seq, c.hidden_size), dtype=np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal(
        (c.hidden_size, 4 * c.hidden_size), dtype=np.float32)).to(
        dev, torch.bfloat16)

    def fn():
        return ((x @ w) @ w.T) * 1e-3

    return fn, 2 * 2 * s.batch * s.seq * c.hidden_size * 4 * c.hidden_size


PROBES = {"step": probe_step, "vis_tower": probe_vis_tower,
          "vis_attn": probe_vis_attn, "txt_flash": probe_txt_flash,
          "txt_stack": probe_txt_stack, "logits": probe_logits,
          "adamw": probe_adamw, "embed": probe_embed, "mm_768": probe_mm_768}
# probes of a single fast call: 4x the iterations, as the JAX tool
SHORT = ("logits", "adamw", "embed", "mm_768")


def run(shape: GitShape = FLAGSHIP, probes: Sequence[str] = tuple(PROBES),
        iters: int = 8, device: DeviceLike = "cuda",
        emit: Callable[[Dict[str, Any]], None] = lambda row: None, **extra
        ) -> List[Dict[str, Any]]:
    """Time ``probes`` at ``shape``; returns the rows (each with
    ``extra``, and passed to ``emit`` as it is taken)."""
    dev = resolve_device(device)
    rows = []
    for name in probes:
        n = iters * 4 if name in SHORT else iters
        row = measure(name, lambda: PROBES[name](shape, dev), n, dev,
                      **extra)
        if name == "step":
            row["qa_pairs_per_s"] = shape.batch / (row["ms"] / 1e3)
        emit(row)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--probe", action="append", choices=sorted(PROBES),
                   help="probes to run (default: all)")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"device": torch.cuda.get_device_name(dev),
                          "shape": dataclasses.asdict(FLAGSHIP),
                          "seq": FLAGSHIP.seq}), flush=True)
    run(FLAGSHIP, args.probe or tuple(PROBES), args.iters, dev,
        emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
