"""Optimizer, train steps and eval step (counterpart of
sasvqa_tpu/train/steps.py), for the GIT family.

- :func:`make_optimizer` builds the JAX package's optax chain by hand:
  clip by global norm -> AdamW (masked decoupled weight decay, LR
  schedule) -> masked lr_mul scale, with optax's numerics (clip only when
  the norm reaches the limit, as ``(g / norm) * max``; the schedule read at
  the update count before it is incremented; bias correction in f32);
- :func:`make_scan_train_step` accumulates K micro-batches' gradients
  (Welford mean, or the plain sum) and runs one optimizer update per K
  micros; :func:`make_git_train_step` is the one-micro form.

The port updates parameters in place (the JAX package returns a new
state): a step returns the same :class:`TrainState` with ``step``
advanced, and leaves the gradient it applied in each parameter's
``.grad``.  Dropout in a step draws from a ``torch.Generator`` seeded from
(seed, micro step), the counterpart of ``jax.random.fold_in``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.models.git import GITForCausalLM, greedy_generate
from sasvqa_torch.models.layers import Dense, Embed, LayerNorm
from sasvqa_torch.train.schedules import Schedule, get_lr_schedule, lr_value

# Flax parameter-path fragments that never get weight decay: every bias
# and the LayerNorm ``scale`` (the reference's no_decay list); embeddings
# do decay.  Leaves of fewer than 2 dims never decay either.
NO_DECAY_FRAGMENTS = ("bias", "scale")

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


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies (2-D+ leaves
    whose Flax path names no bias or LayerNorm scale)."""
    flax = flax_param_names(model)
    return {name: (p.dim() >= 2 and not any(
        frag in part.lower() for part in flax[name].split(".")
        for frag in NO_DECAY_FRAGMENTS))
        for name, p in model.named_parameters()}


def lr_mul_mask(model: nn.Module, prefix: str) -> Dict[str, bool]:
    """Parameter name -> True where the Flax-equivalent dotted name
    contains ``prefix`` (the reference's substring rule)."""
    flax = flax_param_names(model)
    return {name: prefix in flax[name] for name, _ in model.named_parameters()}


def _f32(x: float) -> float:
    return float(np.float32(x))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class AdamW:
    """The optax chain of ``make_optimizer``, applied in place.

    ``update(grads)`` clips the gradients by their global norm
    (``max_norm`` > 0), forms the Adam update from f32 moments with
    f32 bias correction, adds ``weight_decay * param`` where ``decay``
    holds, scales by ``-schedule(count)`` and by ``lr_mul``, adds the
    result to the parameters and returns the global norm before
    clipping.  ``count`` counts updates."""

    def __init__(self, params: Sequence[nn.Parameter], schedule: Schedule,
                 b1: float, b2: float, weight_decay: float,
                 decay: Sequence[bool], lr_mul: Sequence[float],
                 max_norm: float = -1.0, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay = list(decay)
        self.lr_mul = list(lr_mul)
        self.max_norm = max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        if self.max_norm and self.max_norm > 0:
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, (g / norm) * self.max_norm)
                     for g in grads]
        neg_lr = _f32(-self.schedule(self.count))  # pre-increment count
        self.count += 1
        t = np.float32(self.count)
        bc1 = _f32(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(self.b2) ** t)
        for p, g, mu, nu, decay, mul in zip(self.params, grads, self.mu,
                                            self.nu, self.decay, self.lr_mul):
            g = g.float()
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if decay:
                upd = upd + self.weight_decay * p
            upd = upd * neg_lr
            if mul != 1.0:
                upd = upd * mul
            p.add_(upd)
        return norm


def _milestones(cfg: Mapping[str, Any], total_steps: int) -> List[int]:
    steps_per_epoch = max(
        total_steps // max(cfg.get("num_train_epochs", 1), 1), 1)
    return [m * steps_per_epoch
            for m in (cfg.get("step_decay_epochs") or [])]


def make_optimizer(cfg: Mapping[str, Any], total_steps: int,
                   model: nn.Module) -> AdamW:
    """AdamW over ``model``'s parameters from a task config: betas,
    ``weight_decay`` masked off biases and LayerNorm scales, the LR
    schedule (``decay``, ``learning_rate``, ``warmup_ratio``,
    ``step_decay_epochs``, ``gamma``), ``grad_norm`` clipping and the
    ``transformer_lr_mul``/``transformer_lr_mul_prefix`` group."""
    name = str(cfg.get("optim", "adamw")).lower()
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported "
                                  f"(adamw only)")
    if str(cfg.get("adamw_moment_dtype", "f32")) != "f32":
        raise NotImplementedError("low-precision Adam moments are not "
                                  "ported (f32 only)")
    if cfg.get("gradient_accumulation_steps", 1) > 1 \
            and not cfg.get("scan_accum", 1):
        raise NotImplementedError("MultiSteps accumulation is not ported: "
                                  "use make_scan_train_step")
    sched = get_lr_schedule(
        cfg.get("decay", "constant"), cfg["learning_rate"],
        total_steps=total_steps, warmup_ratio=cfg.get("warmup_ratio", 0.1),
        milestones=_milestones(cfg, total_steps), gamma=cfg.get("gamma", 0.5))
    betas = cfg.get("betas", [0.9, 0.98])
    named = list(model.named_parameters())
    decay = decay_mask(model)
    lr_mul = cfg.get("transformer_lr_mul", 1.0)
    prefix = cfg.get("transformer_lr_mul_prefix", "")
    mul = lr_mul_mask(model, prefix) if prefix and lr_mul != 1.0 else {}
    return AdamW([p for _, p in named], sched, float(betas[0]),
                 float(betas[1]), cfg.get("weight_decay", 1e-3),
                 [decay[n] for n, _ in named],
                 [lr_mul if mul.get(n) else 1.0 for n, _ in named],
                 max_norm=cfg.get("grad_norm", -1) or -1.0)


def lr_at(cfg: Mapping[str, Any], total_steps: int, global_step: int) -> float:
    """The learning rate applied by the update that produced
    ``global_step`` (1-based): the schedule at update count
    ``global_step - 1``."""
    return lr_value(cfg.get("decay", "constant"), cfg["learning_rate"],
                    max(int(global_step) - 1, 0), total_steps=total_steps,
                    warmup_ratio=cfg.get("warmup_ratio", 0.1),
                    milestones=_milestones(cfg, total_steps),
                    gamma=cfg.get("gamma", 0.5))


@dataclasses.dataclass
class TrainState:
    """``step`` counts micro steps; the model holds the parameters."""
    step: int
    model: GITForCausalLM
    optimizer: AdamW


def create_train_state(model: GITForCausalLM, cfg: Mapping[str, Any],
                       total_steps: int, device: DeviceLike = "cuda"
                       ) -> TrainState:
    """Move ``model`` to ``device`` in training mode and build its
    optimizer."""
    model.to(resolve_device(device)).train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, total_steps, model))


_M64 = (1 << 64) - 1


def fold_in(seed: int, n: int) -> int:
    """A generator seed from (seed, n): a splitmix64 finalizer of both
    (counterpart of ``jax.random.fold_in``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(n) + 1) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)
    return t.to(device=device, dtype=dtype)


def _git_loss(model: GITForCausalLM, batch: Mapping[str, Any],
              generator: torch.Generator, dev: torch.device) -> torch.Tensor:
    return model(_tensor(batch["text_input_ids"], dev, torch.long),
                 _tensor(batch["text_attention_mask"], dev),
                 _tensor(batch["visual_inputs"], dev),
                 labels=_tensor(batch["labels"], dev, torch.long),
                 deterministic=False, generator=generator)["loss"]


def _accumulate_and_update(state: TrainState,
                           micros: Sequence[Mapping[str, Any]], seed: int,
                           grad_mean: bool, dev: torch.device
                           ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    params = state.optimizer.params
    acc: List[torch.Tensor] = []
    losses = []
    for i, mb in enumerate(micros):
        gen = torch.Generator(device=dev).manual_seed(
            fold_in(seed, state.step + i))
        for p in params:
            p.grad = None
        loss = _git_loss(state.model, mb, gen, dev)
        loss.backward()
        losses.append(loss.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if i == 0:          # 0 + (g - 0) / 1 and 0 + g are g exactly
            acc = grads
        elif grad_mean:     # Welford running mean, as optax.MultiSteps
            for a, g in zip(acc, grads):
                a.add_((g - a) / (i + 1))
        else:               # the reference's sum over the window
            for a, g in zip(acc, grads):
                a.add_(g)
    for p, a in zip(params, acc):
        p.grad = a
    gnorm = state.optimizer.update(acc)
    state.step += len(micros)
    return state, {"loss": torch.stack(losses).mean(), "grad_norm": gnorm}


TrainStep = Callable[[TrainState, Dict[str, Any], int],
                     Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_git_train_step(device: DeviceLike = "cuda") -> TrainStep:
    """Train step for GIT (loss from LM labels): ``step(state, batch,
    seed) -> (state, {"loss", "grad_norm"})``, one optimizer update per
    batch; dropout draws from a generator seeded from (seed,
    state.step)."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, Any], seed: int):
        return _accumulate_and_update(state, [batch], seed, True, dev)

    return step


def make_scan_train_step(k_micro: int, family: str = "git",
                         grad_mean: bool = True,
                         device: DeviceLike = "cuda") -> TrainStep:
    """One call = one optimizer update over ``k_micro`` stacked
    micro-batches (every array leaf of the batch is (K, B, ...), as
    ``data.pipeline.stack_microbatches`` makes it).

    Micro i draws its dropout from a generator seeded from (seed,
    state.step + i); ``state.step`` advances by K.  Gradients accumulate
    as the Welford running mean ``acc + (g - acc)/(i+1)``, or as the sum
    with ``grad_mean=False`` (the reference's per-micro backward without
    /K).  Metrics: ``loss`` is the mean over the K micros, ``grad_norm``
    the norm of the accumulated gradient before clipping."""
    if k_micro < 1:
        raise ValueError(f"k_micro must be >= 1, got {k_micro}")
    if family != "git":
        raise NotImplementedError(f"the {family} family is not ported yet "
                                  f"(GIT only)")
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, Any], seed: int):
        micros = [{key: batch[key][i] for key in
                   ("text_input_ids", "text_attention_mask",
                    "visual_inputs", "labels")} for i in range(k_micro)]
        return _accumulate_and_update(state, micros, seed, grad_mean, dev)

    return step


def make_git_eval_step(model: GITForCausalLM, max_text_len: int = 50,
                       max_new_tokens: Optional[int] = None,
                       device: DeviceLike = "cuda"
                       ) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Generative eval: batch -> (B, max_new) greedy token ids on
    ``device``, computed under ``torch.inference_mode()`` (greedy_generate
    enters it).  ``max_new_tokens=None`` decodes to the full
    ``max_text_len`` budget, with the all-done early exit."""
    dev = resolve_device(device)

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        return greedy_generate(
            model, batch["text_input_ids"], batch["prompt_len"],
            batch["visual_inputs"], max_text_len=max_text_len,
            max_new_tokens=max_new_tokens, device=dev)

    return step
