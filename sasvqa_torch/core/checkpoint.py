"""Checkpoint / resume on ``torch.save`` (counterpart of
sasvqa_tpu/core/checkpoint.py, which uses Orbax).

The reference's two checkpoint roles (src/utils/load_save.py:37-62,
239-307):

- **eval snapshots**: ``ckpt/model_step_{N}.pt``, parameters only, at
  each validation (:class:`ModelSaver`);
- **preemption restore**: ``restore/step_{N}.pt`` holds the whole train
  state (parameters, the optimizer's state: its count and moments, and
  under MultiSteps the open window's accumulated gradients and mini-step;
  the micro step), the two newest kept, resumed automatically at startup
  (:class:`TrainingRestorer`).

Every file is written to a temporary name and renamed into place, so a
crash mid-save never leaves a half-written checkpoint under a step's
name.  Saves are synchronous; ``wait()`` exists for the loop's calls.
Also captures run metadata (args.json + source zip,
:func:`save_training_meta`).  Files hold tensors and plain containers
only and are read back with ``torch.load(weights_only=True)``.

Under a process group saves and restores are collective: every rank
gathers the whole tensors of sharded parameters and moments, rank 0
alone writes the same files one process writes, and every rank waits at
a barrier; on restore every rank reads the whole state and keeps its
shards.  So a snapshot resumes at any rank count.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch

from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.parallel.mesh import (barrier, fetch_params_for_save,
                                        load_full_state_dict, rank)
from sasvqa_torch.utils.basic import ensure_dir, save_json, zip_source_tree


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
        """Rank 0 writes; every rank returns once the file is in place."""
        if rank() == 0:
            _atomic_save(obj, self.path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        barrier()

    def load(self, step: int) -> Any:
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)


class ModelSaver:
    """Eval-time parameter snapshots keyed by global step."""

    def __init__(self, output_dir: str, max_to_keep: int = 10):
        self._files = _StepFiles(output_dir, "model_step_", max_to_keep)
        self.dir = self._files.dir

    def save(self, step: int, params: Mapping[str, torch.Tensor]) -> None:
        """``params``: a module's ``state_dict()`` (every rank calls it)."""
        self._files.save(step, fetch_params_for_save(params))

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
    """What a restore must match: the optimizer and its accumulation
    formulation (``kind``: e.g. ``adamw``, ``adamw/bf16``, ``adamax``,
    ``sgd``, ``multisteps(adam)``; each keeps other state) and each
    parameter's name and shape."""
    return {"optimizer": state.optimizer.kind,
            "params": {n: list(p.shape)
                       for n, p in state.model.named_parameters()}}


# The kinds whose state a snapshot of the older layout, {"formulation":
# "scan", "params": ...}, holds: the scan form with f32 Adam or AdamW
# moments, saved as {"count", "mu", "nu"} as these kinds save them now.
_SCAN_FORMULATION_KINDS = ("adam", "adamw")


def _saved_layout(layout: Mapping[str, Any], kind: str) -> Dict[str, Any]:
    """A saved layout in the current form: one of the older form, which
    does not say whether its moments came from Adam or AdamW, reads as
    the resuming run's kind when that is one of the two."""
    if "formulation" not in layout:
        return dict(layout)
    return {"optimizer": (kind if kind in _SCAN_FORMULATION_KINDS
                          else "adam(w) f32, scan accumulation"),
            "params": layout["params"]}


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
        self._files.save(step, {
            "layout": _layout(state),
            "params": fetch_params_for_save(state.model.state_dict()),
            "opt_state": state.optimizer.state_dict(),
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
        parameters, optimizer state, micro step); ``state`` unchanged when
        there is none."""
        latest = self._files.latest_step()
        if latest is None:
            return state
        saved = self._files.load(latest)
        ours = _layout(state)
        theirs = _saved_layout(saved["layout"], ours["optimizer"])
        if theirs != ours:
            what = ("the optimizer or its accumulation formulation "
                    f"({theirs['optimizer']} saved, {ours['optimizer']} now)"
                    if theirs["optimizer"] != ours["optimizer"] else
                    "the model's parameter names or shapes")
            raise FormulationMismatchError(
                f"restore checkpoint step {latest} under {self.dir} has "
                f"another state layout than this run ({what} changed); "
                f"restart from an eval snapshot (params only) instead")
        LOGGER.info(f"auto-resuming from restore checkpoint step {latest}")
        load_full_state_dict(state.model, saved["params"])
        state.optimizer.load_state_dict(saved["opt_state"])
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
