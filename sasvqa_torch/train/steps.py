"""Optimizer, train steps and eval steps (counterpart of
sasvqa_tpu/train/steps.py), for the GIT family, the CLIP/BLIP answer
classifiers and TGIF-QA multiple choice.

- :func:`make_optimizer` builds the JAX package's optax chain by hand:
  clip by global norm -> AdamW (masked decoupled weight decay, LR
  schedule; f32 or bf16 moments), Adam (no decay), Adamax or SGD ->
  masked lr_mul scale, with optax's numerics (clip only when the norm
  reaches the limit, as ``(g / norm) * max``; the schedule read at the
  update count before it is incremented; bias correction in f32), and
  with ``scan_accum: 0`` the optax.MultiSteps wrapper
  (:class:`MultiSteps`);
- :func:`make_scan_train_step` accumulates K micro-batches' gradients
  (Welford mean, or the plain sum) and runs one optimizer update per K
  micros, for ``family="git"`` (LM loss), ``"classifier"`` (answer
  classification, with train-accuracy counts) or ``"mc"`` (multiple
  choice); :func:`make_git_train_step`, :func:`make_classifier_train_step`
  and :func:`make_mc_train_step` are the one-micro forms;
- the eval steps: greedy decode for GIT, argmax labels or raw logits for
  the classifier, argmax options for multiple choice.

The port updates parameters in place (the JAX package returns a new
state): a step returns the same :class:`TrainState` with ``step``
advanced, and leaves the gradient it applied in each parameter's
``.grad``.  Dropout in a step draws from a ``torch.Generator`` seeded from
(seed, micro step), the counterpart of ``jax.random.fold_in``.

On one GPU a step replays each micro-batch's forward, backward and
gradient accumulation from one captured CUDA graph (:class:`MicroGraph`)
where it can observe that the graph does the eager path's work
(:func:`_micro`, which both run): the same draws and the same numbers.
``micro_counts`` counts the micros replayed and those run eagerly.

Under a process group (``TrainState.plan``, a
:class:`~sasvqa_torch.parallel.mesh.ParallelPlan`) a step computes the
JAX package's loss over the global batch: each micro all-reduces its
count of loss targets, each rank scales its local mean by its share of
that count, and the gradients are summed over the data-parallel ranks
once a micro (by FSDP2 for the leaves it shards, by one coalesced
all-reduce for the rest).  Parameters, gradients and optimizer moments
may be DTensors; the optimizer works on each rank's shards and clips by
the global norm over every shard.  The dropout generator folds in the
rank's data-parallel coordinate, so that tensor-parallel replicas draw
the same masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.core.pixels import host_tensor
from sasvqa_torch.core.profiling import span
from sasvqa_torch.models.convert import flax_param_names
from sasvqa_torch.models.git import greedy_generate
from sasvqa_torch.ops import _build
from sasvqa_torch.parallel.mesh import (ParallelPlan, full, is_dtensor,
                                        load_full_into, local)
from sasvqa_torch.train.schedules import Schedule, get_lr_schedule, lr_value

# Flax parameter-path fragments that never get weight decay: every bias
# and the LayerNorm ``scale`` (the reference's no_decay list); embeddings
# do decay.  Leaves of fewer than 2 dims never decay either.
NO_DECAY_FRAGMENTS = ("bias", "scale")


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
    """sqrt of the sum of squares of every element, in f32.  A DTensor
    counts each of its elements once: its shards' partial sums are
    reduced over the mesh dims it is sharded on (one reduction for each
    layout)."""
    total = sum(torch.sum(t.float() * t.float()) for t in tensors
                if not is_dtensor(t))
    partial: Dict[Any, torch.Tensor] = {}
    for t in filter(is_dtensor, tensors):
        key = (t.device_mesh, tuple(t.placements))
        lt = t.to_local().float()
        partial[key] = partial.get(key, 0) + torch.sum(lt * lt)
    for (mesh, placements), s in partial.items():
        total = total + DTensor.from_local(
            s, mesh, [Replicate() if p.is_replicate() else Partial()
                      for p in placements]).full_tensor()
    return torch.sqrt(total)


class AdamW:
    """The optax chain of ``make_optimizer``, applied in place.

    ``update(grads)`` clips the gradients by their global norm
    (``max_norm`` > 0), forms the Adam update with f32 bias correction,
    adds ``weight_decay * param`` where ``decay`` holds (nowhere for
    optax.adam), scales by ``-schedule(count)`` and by ``lr_mul``, adds
    the result to the parameters and returns the global norm before
    clipping.  ``count`` counts updates.  The moments are stored in
    ``moment_dtype``: f32 (optax.adamw / optax.adam) or bf16 (the JAX
    package's ``_scale_by_adam_lowp``: the moving averages and the update
    are computed in f32 from the stored moments, which alone round).
    ``kind`` names the optimizer and the moments' dtype for the restore
    layout: ``name``, with ``/bf16`` appended for bf16 moments."""

    def __init__(self, params: Sequence[nn.Parameter], schedule: Schedule,
                 b1: float, b2: float, weight_decay: float,
                 decay: Sequence[bool], lr_mul: Sequence[float],
                 max_norm: float = -1.0, eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.float32,
                 name: str = "adam"):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay = list(decay)
        self.lr_mul = list(lr_mul)
        self.max_norm = max_norm
        self.moment_dtype = moment_dtype
        self.kind = name + ("/bf16" if moment_dtype == torch.bfloat16
                            else "")
        self.count = 0
        self._init_moments()

    def _init_moments(self) -> None:
        self.mu = [torch.zeros_like(p, dtype=self.moment_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=self.moment_dtype)
                   for p in self.params]

    def _moments(self) -> Dict[str, List[torch.Tensor]]:
        return {"mu": self.mu, "nu": self.nu}

    def _corrections(self, t: np.float32) -> None:
        self._bc1 = _f32(np.float32(1.0) - np.float32(self.b1) ** t)
        self._bc2 = _f32(np.float32(1.0) - np.float32(self.b2) ** t)

    def _direction(self, i: int, g: torch.Tensor) -> torch.Tensor:
        mu, nu = local(self.mu[i]), local(self.nu[i])
        if self.moment_dtype == torch.float32:
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            return (mu / self._bc1) / (torch.sqrt(nu / self._bc2) + self.eps)
        m32 = self.b1 * mu.float() + (1.0 - self.b1) * g
        v32 = self.b2 * nu.float() + (1.0 - self.b2) * g * g
        mu.copy_(m32)
        nu.copy_(v32)
        return (m32 / self._bc1) / (torch.sqrt(v32 / self._bc2) + self.eps)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        # every update below is elementwise: it runs on each rank's shards
        grads = [local(g) for g in grads]
        if self.max_norm and self.max_norm > 0:
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, (g / norm) * self.max_norm)
                     for g in grads]
        neg_lr = _f32(-self.schedule(self.count))  # pre-increment count
        self.count += 1
        self._corrections(np.float32(self.count))
        for i, (p, g, decay, mul) in enumerate(zip(
                self.params, grads, self.decay, self.lr_mul)):
            p = local(p)
            upd = self._direction(i, g.float())
            if decay:
                upd = upd + self.weight_decay * p
            upd = upd * neg_lr
            if mul != 1.0:
                upd = upd * mul
            p.add_(upd)
        return norm

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer state as whole tensors (on the CPU) and ints
        (every rank calls it: sharded moments are gathered)."""
        return {"count": self.count,
                **{k: [full(t).detach().cpu() for t in v]
                   for k, v in self._moments().items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        for key, dst in self._moments().items():
            for d, src in zip(dst, state[key]):
                load_full_into(d, src)
        self.count = int(state["count"])


class Adamax(AdamW):
    """optax.adamax in the same chain: ``mu`` the moving average of the
    gradients, ``nu`` the decayed infinity norm ``max(|g| + eps, b2 *
    nu)``, the update ``(mu / (1 - b1^t)) / nu``; no weight decay."""

    def __init__(self, params, schedule, b1, b2, decay, lr_mul,
                 max_norm=-1.0):
        super().__init__(params, schedule, b1, b2, 0.0, decay, lr_mul,
                         max_norm, name="adamax")

    def _corrections(self, t: np.float32) -> None:
        self._bc1 = _f32(np.float32(1.0) - np.float32(self.b1) ** t)

    def _direction(self, i: int, g: torch.Tensor) -> torch.Tensor:
        mu, nu = local(self.mu[i]), local(self.nu[i])
        mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
        nu.copy_(torch.maximum(g.abs() + self.eps, self.b2 * nu))
        return (mu / self._bc1) / nu


class SGD(AdamW):
    """optax.sgd without momentum in the same chain: the update is the
    (clipped) gradient itself; no optimizer state but the count."""

    def __init__(self, params, schedule, decay, lr_mul, max_norm=-1.0):
        super().__init__(params, schedule, 0.0, 0.0, 0.0, decay, lr_mul,
                         max_norm, name="sgd")

    def _init_moments(self) -> None:
        pass

    def _moments(self) -> Dict[str, List[torch.Tensor]]:
        return {}

    def _corrections(self, t: np.float32) -> None:
        pass

    def _direction(self, i: int, g: torch.Tensor) -> torch.Tensor:
        return g


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=K, use_grad_mean) applied
    in place: each ``update`` (one a micro-batch) adds the micro's
    gradients into the accumulator, as the Welford mean ``acc + (g -
    acc)/(n+1)`` or the plain sum, and every K-th one runs the inner
    update on the accumulated gradients and zeroes them.  ``mini_step``
    counts the micros of the open window, ``gradient_step`` the updates;
    the inner count (and so the learning rate) advances once an update.
    Returns the global norm of the micro's own gradients (the JAX step's
    ``grad_norm``)."""

    def __init__(self, inner: AdamW, every_k: int, use_grad_mean: bool):
        self.inner = inner
        self.params = inner.params
        self.every_k = int(every_k)
        self.use_grad_mean = bool(use_grad_mean)
        self.kind = f"multisteps({inner.kind})"
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        n = self.mini_step
        for a, g in zip(map(local, self.acc), map(local, grads)):
            if self.use_grad_mean:
                a.add_((g - a) / (n + 1))
            else:
                a.add_(g)
        if n == self.every_k - 1:
            self.inner.update(self.acc)
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
            self.gradient_step += 1
        else:
            self.mini_step = n + 1
        return global_norm(grads)

    def state_dict(self) -> Dict[str, Any]:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": [full(a).detach().cpu() for a in self.acc],
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        for dst, src in zip(self.acc, state["acc"]):
            load_full_into(dst, src)
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        self.inner.load_state_dict(state["inner"])


Optimizer = Union[AdamW, MultiSteps]
OPTIMIZERS = ("adamw", "adam", "adamax", "sgd")


def _milestones(cfg: Mapping[str, Any], total_steps: int) -> List[int]:
    steps_per_epoch = max(
        total_steps // max(cfg.get("num_train_epochs", 1), 1), 1)
    return [m * steps_per_epoch
            for m in (cfg.get("step_decay_epochs") or [])]


def make_optimizer(cfg: Mapping[str, Any], total_steps: int,
                   model: nn.Module) -> Optimizer:
    """The JAX package's optimizer over ``model``'s parameters from a task
    config: ``optim`` adamw (the default, and the fallback of an unknown
    name, as in the JAX package), adam, adamax or sgd (no momentum);
    betas (the Adam family), ``weight_decay`` masked off biases and
    LayerNorm scales (adamw only), ``adamw_moment_dtype: "bf16"`` (adamw
    only), the LR schedule (``decay``, ``learning_rate``,
    ``warmup_ratio``, ``step_decay_epochs``, ``gamma``), ``grad_norm``
    clipping and the ``transformer_lr_mul``/``transformer_lr_mul_prefix``
    group.  ``gradient_accumulation_steps`` K > 1 with ``scan_accum: 0``
    wraps it in :class:`MultiSteps` (``accum_grad_mean``), to be called
    once a micro-batch."""
    name = str(cfg.get("optim", "adamw")).lower()
    if name not in OPTIMIZERS:
        LOGGER.warning(f"unknown optimizer {name!r}: using adamw")
        name = "adamw"
    sched = get_lr_schedule(
        cfg.get("decay", "constant"), cfg["learning_rate"],
        total_steps=total_steps, warmup_ratio=cfg.get("warmup_ratio", 0.1),
        milestones=_milestones(cfg, total_steps), gamma=cfg.get("gamma", 0.5))
    betas = cfg.get("betas", [0.9, 0.98])
    named = list(model.named_parameters())
    params = [p for _, p in named]
    decay = decay_mask(model) if name == "adamw" else {}
    decay = [decay.get(n, False) for n, _ in named]
    lr_mul = cfg.get("transformer_lr_mul", 1.0)
    prefix = cfg.get("transformer_lr_mul_prefix", "")
    mul = lr_mul_mask(model, prefix) if prefix and lr_mul != 1.0 else {}
    mul = [lr_mul if mul.get(n) else 1.0 for n, _ in named]
    max_norm = cfg.get("grad_norm", -1) or -1.0
    if name == "sgd":
        opt: AdamW = SGD(params, sched, decay, mul, max_norm=max_norm)
    elif name == "adamax":
        opt = Adamax(params, sched, float(betas[0]), float(betas[1]),
                     decay, mul, max_norm=max_norm)
    else:
        lowp = name == "adamw" and \
            str(cfg.get("adamw_moment_dtype", "f32")) == "bf16"
        opt = AdamW(params, sched, float(betas[0]), float(betas[1]),
                    cfg.get("weight_decay", 1e-3) if name == "adamw"
                    else 0.0, decay, mul, max_norm=max_norm,
                    moment_dtype=torch.bfloat16 if lowp else torch.float32,
                    name=name)
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    if accum > 1 and not cfg.get("scan_accum", 1):
        return MultiSteps(opt, accum, bool(cfg.get("accum_grad_mean", 1)))
    return opt


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
    """``step`` counts micro steps; the model holds the parameters;
    ``plan`` says how the ranks of a process group share the work (None:
    one process)."""
    step: int
    model: nn.Module
    optimizer: Optimizer
    plan: Optional[ParallelPlan] = None


def create_train_state(model: nn.Module, cfg: Mapping[str, Any],
                       total_steps: int, device: DeviceLike = "cuda",
                       plan: Optional[ParallelPlan] = None) -> TrainState:
    """Move ``model`` to ``device`` in training mode and build its
    optimizer.  A sharded model (``plan`` from
    ``parallel.mesh.param_sharding_for_mesh``) is sharded before this, so
    that the optimizer holds its sharded parameters."""
    model.to(resolve_device(device)).train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, total_steps, model),
                      plan=plan)


_M64 = (1 << 64) - 1


def fold_in(seed: int, n: int) -> int:
    """A generator seed from (seed, n): a splitmix64 finalizer of both
    (counterpart of ``jax.random.fold_in``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(n) + 1) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    return host_tensor(x).to(device=device, dtype=dtype)


def _inputs(batch: Mapping[str, Any], dev: torch.device):
    return (_tensor(batch["text_input_ids"], dev, torch.long),
            _tensor(batch["text_attention_mask"], dev),
            _tensor(batch["visual_inputs"], dev))


def _git_loss(model: nn.Module, batch: Mapping[str, Any],
              generator: torch.Generator, dev: torch.device
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward (dropouts on) of one micro-batch; its loss
    averages over the shifted labels other than -100."""
    labels = _tensor(batch["labels"], dev, torch.long)
    out = model(*_inputs(batch, dev), labels=labels, deterministic=False,
                generator=generator)
    return out["loss"], {"n_targets": (labels[:, 1:] != -100).sum()}


def _classifier_loss(model: nn.Module, batch: Mapping[str, Any],
                     generator: torch.Generator, dev: torch.device
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and the train-accuracy counts over labels other than -100.
    The CE loss averages over those labels, a bce or mse loss over the
    rows."""
    labels = _tensor(batch["labels"], dev, torch.long)
    out = model(*_inputs(batch, dev), labels=labels, deterministic=False,
                generator=generator)
    valid = labels != -100
    correct = (out["logits"].argmax(dim=-1) == labels) & valid
    head = getattr(model, "head", None)
    ce = labels.dim() == 1 and getattr(head, "loss_type", "ce") == "ce"
    n = valid.sum() if ce else torch.full((), labels.shape[0], device=dev)
    return out["loss"], {"acc_correct": correct.sum(),
                         "acc_total": valid.sum(), "n_targets": n}


def _mc_loss(model: nn.Module, batch: Mapping[str, Any],
             generator: torch.Generator, dev: torch.device, n_options: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multiple-choice loss and accuracy counts: every question counts
    (option indices have no -100)."""
    labels = _tensor(batch["labels"], dev, torch.long)
    out = model.multiple_choice(*_inputs(batch, dev), n_options,
                                labels=labels, deterministic=False,
                                generator=generator)
    correct = out["logits"].argmax(dim=-1) == labels
    n = torch.full((), labels.shape[0], device=dev)
    return out["loss"], {"acc_correct": correct.sum(), "acc_total": n,
                         "n_targets": n}


_LOSSES = {"git": _git_loss, "classifier": _classifier_loss, "mc": _mc_loss}

LossFn = Callable[[nn.Module, Mapping[str, Any], torch.Generator,
                   torch.device],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _loss_fn(family: str, n_options: int) -> LossFn:
    if family not in _LOSSES:
        raise ValueError(f"unknown family {family!r} (git, classifier or "
                         f"mc)")
    if family == "mc":
        if n_options < 1:
            raise ValueError("the mc family needs n_options >= 1")
        return partial(_mc_loss, n_options=n_options)
    return _LOSSES[family]


# micros of the train steps replayed from a captured graph and run
# eagerly, as ``ops._build.launch_counts`` counts kernel launches
micro_counts: Dict[str, int] = {"replayed": 0, "eager": 0}


def reset_micro_counts() -> None:
    for name in micro_counts:
        micro_counts[name] = 0


# the leaves of a micro-batch the losses read
_MICRO_KEYS = ("text_input_ids", "text_attention_mask", "visual_inputs",
               "labels")


def _uses_remat(model: nn.Module) -> bool:
    return any(getattr(m, "remat", False) for m in model.modules())


def _welford_factor(i: int) -> float:
    """The factor of micro ``i``'s step of the Welford mean, ``a + (g -
    a) * factor``: the f32 reciprocal of i + 1, which is what ATen
    multiplies a CUDA tensor by where it is divided by the host scalar
    i + 1."""
    return float(np.float32(1.0) / np.float32(i + 1))


def _micro(model: nn.Module, params: Sequence[torch.Tensor],
           mb: Mapping[str, Any], gen: torch.Generator, dev: torch.device,
           loss_fn: LossFn, acc: Optional[List[torch.Tensor]],
           factor: Union[float, torch.Tensor, None],
           plan: Optional[ParallelPlan] = None,
           micro: Optional[int] = None):
    """One micro-batch, as the eager path runs it and a graph holds it:
    the training forward (dropouts drawing from ``gen``), ``backward()``
    and the accumulation of its gradients into ``acc``: ``a + (g - a) *
    factor``, the Welford mean as optax.MultiSteps (``factor`` the
    micro's :func:`_welford_factor`, a host float or a graph's device
    scalar), or ``a + g``, the reference's sum over the window
    (``factor`` None).  ``acc`` None (micro 0) leaves the gradients to
    the caller.  ``micro``: the micro's index in its update, for its
    spans (a graph's capture, which runs nothing, opens none).  Returns
    the loss, the counts and the gradients."""
    scope = span if micro is not None else _no_span
    with scope("train.forward", micro=micro, graph=0):
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(model, mb, gen, dev)
        n_targets = metrics.pop("n_targets")
        if plan is not None:
            # the global batch's loss: the local mean weighted by this
            # rank's share of the micro's targets, summed over the ranks
            total = plan.all_reduce(n_targets.clone())
            loss = loss * (n_targets / total.clamp(min=1))
    with scope("train.backward", micro=micro):
        loss.backward()
        if plan is not None:
            plan.reduce_grads(params)
    with scope("train.accumulate", micro=micro):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if acc is not None:
            for a, g in zip(acc, grads):
                a.add_(g if factor is None else (g - a).mul_(factor))
    return loss.detach(), metrics, grads


def _no_span(name: str, **attrs: Any) -> contextlib.nullcontext:
    return contextlib.nullcontext()


class MicroGraph:
    """One micro-batch of a train step (:func:`_micro`) as a captured
    CUDA graph.

    A step takes the graph where it can observe that the graph does the
    eager path's work (:meth:`takes`): a CUDA device, one process
    (``state.plan`` None: collectives and FSDP hooks stay eager), a model
    without remat, and a micro whose leaves have the shapes and dtypes of
    the first one it took, on the same model and parameter storage (the
    captured key).  Anything else runs the eager path; a new key does not
    capture a second graph.

    The first ``WARMUP`` micros it takes run the eager path on a side
    stream (kernel builds, cuBLAS workspaces); then the graph is captured
    on that stream, and every later micro replays it: the micro's leaves
    are copied into the static inputs, the dropout generator registered
    with the graph is reseeded with the micro's seed (Philox starts at
    offset 0, as in the eager path's fresh generator), the Welford factor
    is written into a device scalar, and the graph runs.  The static
    accumulators are the warm-up's; micro 0 copies its gradients into
    them.  The launches the capture recorded are counted on each replay
    (``ops._build.count_replay``).  A capture that fails leaves the step
    on the eager path, with a warning."""

    WARMUP = 3

    def __init__(self, loss_fn: LossFn, grad_mean: bool):
        self.loss_fn = loss_fn
        self.grad_mean = grad_mean
        self.key: Optional[Tuple[Any, ...]] = None
        self.warm = 0
        self.failed = False
        self.stream: Optional[torch.cuda.Stream] = None
        self.done: Optional[torch.cuda.Event] = None
        self._replay: Optional[Callable[[], None]] = None
        self.launches: Dict[str, int] = {}

    def takes(self, state: TrainState, dev: torch.device,
              mb: Mapping[str, Any]) -> bool:
        """Whether micro ``mb`` (and each micro of its update, which
        share its shapes) goes the graph's way."""
        if self.failed or dev.type != "cuda" or state.plan is not None:
            return False
        key = (state.model,
               tuple(p.data_ptr() for p in state.optimizer.params),
               tuple((tuple(t.shape), t.dtype)
                     for t in (host_tensor(mb[k]) for k in _MICRO_KEYS)))
        if self.key is None:
            if _uses_remat(state.model):
                return False
            self.key = key
        return key == self.key

    def side_stream(self, dev: torch.device
                    ) -> Optional[torch.cuda.Stream]:
        """The stream of the warm-up and the capture (none off the
        GPU)."""
        if self.stream is None and dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
        return self.stream

    def bound_run_ahead(self) -> None:
        """Mark the end of the update just enqueued, and return once the
        device has ended the update before it: a replayed update is
        enqueued long before the device runs it, and a loop that ran on
        would take staged batches far ahead of the device, so that more
        of them stayed alive than in the eager, launch-bound loop."""
        done = torch.cuda.Event(blocking=True)
        done.record()
        if self.done is not None:
            self.done.synchronize()
        self.done = done

    def ready(self, state: TrainState, dev: torch.device,
              mb: Mapping[str, Any], acc: List[torch.Tensor]) -> bool:
        """Whether this micro replays the graph, capturing it after the
        warm-up; ``acc``: the update's accumulators so far."""
        if self._replay is None and not self.failed:
            if self.warm < self.WARMUP:
                self.warm += 1
                return False
            self._capture(state, dev, mb, acc)
        return self._replay is not None

    def _capture(self, state: TrainState, dev: torch.device,
                 mb: Mapping[str, Any], acc: List[torch.Tensor]) -> None:
        params = state.optimizer.params
        # static buffers, allocated once: the eager warm-up's accumulators
        # become the graph's
        self.inputs = {k: torch.empty_like(host_tensor(mb[k]), device=dev)
                       for k in _MICRO_KEYS}
        self.scale = torch.ones((), dtype=torch.float32, device=dev)
        self.acc = acc or [torch.zeros_like(p) for p in params]
        self.gen = torch.Generator(device=dev)
        try:
            with _build.capturing() as self.launches:
                self._replay = self._record(state.model, params, dev)
        except RuntimeError as e:
            self.failed = True
            LOGGER.warning(f"train step: CUDA graph capture failed, "
                           f"micros stay eager ({e})")

    def _record(self, model: nn.Module, params: Sequence[torch.Tensor],
                dev: torch.device) -> Callable[[], None]:
        """Capture :meth:`_run` (it records; nothing runs) and return
        what runs it."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        # thread_local: the prefetch thread keeps staging batches
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self._run(model, params, dev)
        return graph.replay

    def _run(self, model: nn.Module, params: Sequence[torch.Tensor],
             dev: torch.device) -> None:
        """The graph's work: one micro on the static buffers."""
        self.loss, self.metrics, self.grads = _micro(
            model, params, self.inputs, self.gen, dev, self.loss_fn,
            self.acc, self.scale if self.grad_mean else None)

    def replay(self, mb: Mapping[str, Any], micro_seed: int,
               i: int) -> None:
        """Run micro ``i`` of an update through the graph."""
        for k, t in self.inputs.items():
            t.copy_(host_tensor(mb[k]))
        self.gen.manual_seed(micro_seed)
        if self.grad_mean:
            self.scale.fill_(_welford_factor(i))
        self._replay()
        _build.count_replay(self.launches)
        micro_counts["replayed"] += 1

    def outputs(self, i: int) -> Tuple[torch.Tensor,
                                       Dict[str, torch.Tensor]]:
        """Micro ``i``'s loss and counts, cloned out of the static outputs
        that the next replay overwrites; micro 0 also sets the
        accumulators to its gradients (its own accumulation into the last
        update's is overwritten), as the eager path adopts them."""
        if i == 0:
            torch._foreach_copy_(self.acc, self.grads)
        return (self.loss.clone(),
                {k: v.clone() for k, v in self.metrics.items()})


def _accumulate(state: TrainState, micros: Sequence[Mapping[str, Any]],
                seed: int, grad_mean: bool, dev: torch.device,
                loss_fn: LossFn, graph: Optional[MicroGraph] = None):
    """The micros' forward, backward and accumulation: (the accumulated
    gradients, each micro's loss, each micro's counts, whether the
    update went the graph's way)."""
    params = state.optimizer.params
    plan = state.plan
    on_graph = graph is not None and graph.takes(state, dev, micros[0])
    side = graph.side_stream(dev) if on_graph else None
    acc: List[torch.Tensor] = []
    losses, counts = [], []
    for i, mb in enumerate(micros):
        micro_seed = fold_in(seed, state.step + i)
        if plan is not None and plan.dp_size > 1:
            micro_seed = fold_in(micro_seed, plan.dp_index)
        if on_graph and graph.ready(state, dev, mb, acc):
            with span("train.forward", micro=i, graph=1):
                graph.replay(mb, micro_seed, i)
            with span("train.accumulate", micro=i):
                loss, metrics = graph.outputs(i)
                acc = graph.acc
        else:
            micro_counts["eager"] += 1
            if side is not None:    # the graph's warm-up
                side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                gen = torch.Generator(device=dev).manual_seed(micro_seed)
                loss, metrics, grads = _micro(
                    state.model, params, mb, gen, dev, loss_fn,
                    acc if i else None,
                    _welford_factor(i) if grad_mean else None, plan, i)
            if side is not None:
                torch.cuda.current_stream(dev).wait_stream(side)
            if i == 0:          # 0 + (g - 0) * 1 and 0 + g are g exactly
                acc = grads
        losses.append(loss)
        counts.append(metrics)
    return acc, losses, counts, on_graph


def _accumulate_and_update(state: TrainState,
                           micros: Sequence[Mapping[str, Any]], seed: int,
                           grad_mean: bool, dev: torch.device,
                           loss_fn: LossFn, graph: Optional[MicroGraph] = None
                           ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    params = state.optimizer.params
    plan = state.plan
    acc, losses, counts, on_graph = _accumulate(state, micros, seed,
                                                grad_mean, dev, loss_fn,
                                                graph)
    with span("train.optimizer"):
        for p, a in zip(params, acc):
            p.grad = a
        gnorm = state.optimizer.update(acc)
    state.step += len(micros)
    sums = {"loss": torch.stack(losses).mean()}
    for key in counts[0]:
        sums[key] = torch.stack([c[key] for c in counts]).sum()
    if plan is not None:
        # the logged loss and counts are the global batch's
        summed = plan.all_reduce(torch.stack([v.float()
                                              for v in sums.values()]))
        sums = dict(zip(sums, summed.unbind()))
    loss = sums.pop("loss")
    if on_graph:
        graph.bound_run_ahead()
    return state, {"loss": loss, "grad_norm": gnorm, **sums}


TrainStep = Callable[[TrainState, Dict[str, Any], int],
                     Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_git_train_step(device: DeviceLike = "cuda") -> TrainStep:
    """Train step for GIT (loss from LM labels): ``step(state, batch,
    seed) -> (state, {"loss", "grad_norm"})``, one optimizer call per
    batch (an update, or a micro of a :class:`MultiSteps` window);
    dropout draws from a generator seeded from (seed, state.step)."""
    dev = resolve_device(device)
    graph = MicroGraph(_git_loss, True)

    def step(state: TrainState, batch: Dict[str, Any], seed: int):
        return _accumulate_and_update(state, [batch], seed, True, dev,
                                      _git_loss, graph)

    return step


def make_classifier_train_step(device: DeviceLike = "cuda") -> TrainStep:
    """Train step for the classifier family (CLIP/BLIP answer
    classification): ``step(state, batch, seed) -> (state, {"loss",
    "grad_norm", "acc_correct", "acc_total"})``, one optimizer call per
    batch; dropout draws from a generator seeded from (seed,
    state.step)."""
    dev = resolve_device(device)
    graph = MicroGraph(_classifier_loss, True)

    def step(state: TrainState, batch: Dict[str, Any], seed: int):
        return _accumulate_and_update(state, [batch], seed, True, dev,
                                      _classifier_loss, graph)

    return step


def make_mc_train_step(n_options: int, device: DeviceLike = "cuda"
                       ) -> TrainStep:
    """Train step for TGIF-QA multiple choice (``model.multiple_choice``,
    logits (B, n_options), labels (B,) option indices): ``step(state,
    batch, seed) -> (state, {"loss", "acc_correct", "acc_total"})``, one
    optimizer call per batch (the JAX step reports no grad_norm)."""
    dev = resolve_device(device)
    loss_fn = _loss_fn("mc", n_options)
    graph = MicroGraph(loss_fn, True)

    def step(state: TrainState, batch: Dict[str, Any], seed: int):
        state, metrics = _accumulate_and_update(state, [batch], seed, True,
                                                dev, loss_fn, graph)
        del metrics["grad_norm"]
        return state, metrics

    return step


def make_scan_train_step(k_micro: int, family: str = "git",
                         grad_mean: bool = True,
                         device: DeviceLike = "cuda",
                         n_options: int = 0) -> TrainStep:
    """One call = one optimizer update over ``k_micro`` stacked
    micro-batches (every array leaf of the batch is (K, B, ...), as
    ``data.pipeline.stack_microbatches`` makes it).  ``family``: ``"git"``
    (LM loss), ``"classifier"`` (answer classification) or ``"mc"``
    (multiple choice over ``n_options`` options).

    Micro i draws its dropout from a generator seeded from (seed,
    state.step + i); ``state.step`` advances by K.  Gradients accumulate
    as the Welford running mean ``acc + (g - acc)/(i+1)``, or as the sum
    with ``grad_mean=False`` (the reference's per-micro backward without
    /K).  Metrics: ``loss`` is the mean over the K micros, ``grad_norm``
    the norm of the accumulated gradient before clipping; the classifier
    and mc families add ``acc_correct``/``acc_total`` summed over the K
    micros.  On one GPU the micros replay one captured CUDA graph
    (:class:`MicroGraph`), with the same results."""
    if k_micro < 1:
        raise ValueError(f"k_micro must be >= 1, got {k_micro}")
    loss_fn = _loss_fn(family, n_options)
    dev = resolve_device(device)
    graph = MicroGraph(loss_fn, grad_mean)

    def step(state: TrainState, batch: Dict[str, Any], seed: int):
        with span("train.update"):
            micros = [{key: batch[key][i] for key in _MICRO_KEYS}
                      for i in range(k_micro)]
            return _accumulate_and_update(state, micros, seed, grad_mean,
                                          dev, loss_fn, graph)

    return step


def _eval_forward(model: nn.Module, batch: Mapping[str, Any],
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    labels = batch.get("labels")
    return model(*_inputs(batch, dev),
                 labels=None if labels is None
                 else _tensor(labels, dev, torch.long))


def make_classifier_eval_step(model: nn.Module, device: DeviceLike = "cuda"
                              ) -> Callable[[Dict[str, Any]],
                                            Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Classifier eval: batch -> (argmax label ids (B,), loss, or 0 when
    the batch has no labels), computed under ``torch.inference_mode()``
    on ``device``."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(batch: Dict[str, Any]):
        out = _eval_forward(model, batch, dev)
        return (out["logits"].argmax(dim=-1),
                out.get("loss", torch.zeros((), device=dev)))

    return step


def make_mc_eval_step(model: nn.Module, n_options: int,
                      device: DeviceLike = "cuda"
                      ) -> Callable[[Dict[str, Any]],
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """Multiple-choice eval: batch (B*n_options text rows) -> (the argmax
    option index of each question (B,), 0), computed under
    ``torch.inference_mode()`` on ``device``."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(batch: Dict[str, Any]):
        out = model.multiple_choice(*_inputs(batch, dev), n_options)
        return out["logits"].argmax(dim=-1), torch.zeros((), device=dev)

    return step


def make_classifier_logits_step(model: nn.Module,
                                device: DeviceLike = "cuda"
                                ) -> Callable[[Dict[str, Any]],
                                              torch.Tensor]:
    """Classifier eval returning the raw f32 logits (B, num_labels), for
    multi-clip ensembles aggregated outside."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(batch: Dict[str, Any]) -> torch.Tensor:
        return _eval_forward(model, dict(batch, labels=None), dev)["logits"]

    return step


def make_git_eval_step(model: nn.Module, max_text_len: int = 50,
                       max_new_tokens: Optional[int] = None,
                       device: DeviceLike = "cuda",
                       plan: Optional[ParallelPlan] = None
                       ) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Generative eval: batch -> (B, max_new) greedy token ids on
    ``device``, computed under ``torch.inference_mode()`` (greedy_generate
    enters it).  ``max_new_tokens=None`` decodes to the full
    ``max_text_len`` budget, with the all-done early exit (agreed by
    every rank when the ``plan``'s forward communicates)."""
    dev = resolve_device(device)
    all_done = plan.all_done if plan is not None else None

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        return greedy_generate(
            model, batch["text_input_ids"], batch["prompt_len"],
            batch["visual_inputs"], max_text_len=max_text_len,
            max_new_tokens=max_new_tokens, device=dev, all_done=all_done)

    return step
