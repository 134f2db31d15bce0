"""Checkpoint / resume on ``torch.save`` (counterpart of
sasvqa_tpu/core/checkpoint.py, which uses Orbax).

The reference's two checkpoint roles (src/utils/load_save.py:37-62,
239-307):

- **eval snapshots**: ``ckpt/model_step_{N}.pt``, parameters only, at
  each validation (:class:`ModelSaver`);
- **preemption restore**: ``restore/step_{N}.pt`` holds the whole train
  state (parameters, optimizer moments and count, micro step), the two
  newest kept, resumed automatically at startup
  (:class:`TrainingRestorer`).

Every file is written to a temporary name and renamed into place, so a
crash mid-save never leaves a half-written checkpoint under a step's
name.  Saves are synchronous; ``wait()`` exists for the loop's calls.
Also captures run metadata (args.json + source zip,
:func:`save_training_meta`).  Files hold tensors and plain containers
only and are read back with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch

from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.utils.basic import ensure_dir, save_json, zip_source_tree


def _cpu_state(state_dict: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class _StepFiles:
    """``<dir>/<prefix><N>.pt`` files keyed by step, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, prefix: str, max_to_keep: int):
        self.dir = ensure_dir(os.path.abspath(directory))
        self.prefix = prefix
        self.max_to_keep = max_to_keep
        self._pattern = re.compile(rf"^{re.escape(prefix)}(\d+)\.pt$")

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(self._pattern.match,
                                                   os.listdir(self.dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, obj: Any) -> None:
        _atomic_save(obj, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def load(self, step: int) -> Any:
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)


class ModelSaver:
    """Eval-time parameter snapshots keyed by global step."""

    def __init__(self, output_dir: str, max_to_keep: int = 10):
        self._files = _StepFiles(output_dir, "model_step_", max_to_keep)
        self.dir = self._files.dir

    def save(self, step: int, params: Mapping[str, torch.Tensor]) -> None:
        """``params``: a module's ``state_dict()``."""
        self._files.save(step, _cpu_state(params))

    def restore(self, step: int) -> Dict[str, torch.Tensor]:
        """The state dict saved at ``step`` (on the CPU)."""
        if step not in self._files.all_steps():
            raise FileNotFoundError(
                f"no eval snapshot for step {step} under {self.dir} "
                f"(available: {self._files.all_steps()})")
        return self._files.load(step)

    def latest_step(self) -> Optional[int]:
        return self._files.latest_step()

    def wait(self):
        """Saves are synchronous: nothing is in flight."""


class FormulationMismatchError(RuntimeError):
    """A restore checkpoint's state layout (parameter names and shapes,
    optimizer moments, accumulation formulation) differs from the
    resuming run's: loading it would fail half-way or silently corrupt
    the trajectory."""


def _layout(state) -> Dict[str, Any]:
    """What a restore must match: the accumulation formulation (the port
    has only the scan form; the JAX package's MultiSteps wraps its
    optimizer state differently) and each parameter's name and shape."""
    return {"formulation": "scan",
            "params": {n: list(p.shape)
                       for n, p in state.model.named_parameters()}}


class TrainingRestorer:
    """Whole-train-state preemption checkpoints with auto-resume; the two
    newest steps are kept, so a save interrupted mid-write leaves the
    previous one intact."""

    def __init__(self, output_dir: str, save_steps: int = 100):
        self._files = _StepFiles(os.path.join(output_dir, "restore"),
                                 "step_", max_to_keep=2)
        self.dir = self._files.dir
        self.save_steps = max(int(save_steps), 1)

    @property
    def restore_step(self) -> int:
        latest = self._files.latest_step()
        return int(latest) if latest is not None else 0

    def _save(self, step: int, state) -> None:
        opt = state.optimizer
        self._files.save(step, {
            "layout": _layout(state),
            "params": _cpu_state(state.model.state_dict()),
            "opt_state": {"count": opt.count,
                          "mu": [m.detach().cpu() for m in opt.mu],
                          "nu": [n.detach().cpu() for n in opt.nu]},
            "step": int(state.step)})

    def force_save(self, step: int, state) -> bool:
        """Returns True if a checkpoint was written, False if skipped (a
        fresh state at step 0 needs none)."""
        if int(step) < 1:
            LOGGER.info("force_save skipped at step 0 (fresh state)")
            return False
        self._save(step, state)
        return True

    def maybe_save(self, step: int, state) -> None:
        if step > 0 and step % self.save_steps == 0:
            self._save(step, state)

    def restore_into(self, state):
        """Load the newest checkpoint into ``state`` in place (model
        parameters, optimizer moments and count, micro step); ``state``
        unchanged when there is none."""
        latest = self._files.latest_step()
        if latest is None:
            return state
        saved = self._files.load(latest)
        if saved["layout"] != _layout(state):
            raise FormulationMismatchError(
                f"restore checkpoint step {latest} under {self.dir} has "
                f"another state layout than this run (model or "
                f"accumulation formulation changed); restart from an eval "
                f"snapshot (params only) instead")
        LOGGER.info(f"auto-resuming from restore checkpoint step {latest}")
        state.model.load_state_dict(saved["params"], strict=True)
        opt = state.optimizer
        with torch.no_grad():
            for dst, src in zip(opt.mu + opt.nu,
                                saved["opt_state"]["mu"]
                                + saved["opt_state"]["nu"]):
                dst.copy_(src)
        opt.count = int(saved["opt_state"]["count"])
        state.step = int(saved["step"])
        return state

    def wait(self):
        """Saves are synchronous: nothing is in flight."""


def save_training_meta(output_dir: str, cfg) -> None:
    """args.json + source-tree zip (reference load_save.py:16-34)."""
    meta_dir = ensure_dir(os.path.join(output_dir, "log"))
    cfg_dict = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    save_json(cfg_dict, os.path.join(meta_dir, "args.json"),
              save_pretty=True)
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        zip_source_tree(package, os.path.join(meta_dir, "code.zip"))
    except OSError as e:  # metadata capture is not worth failing a run
        LOGGER.warning(f"source zip failed: {e}")
