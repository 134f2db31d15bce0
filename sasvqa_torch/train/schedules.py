"""LR schedules (counterpart of sasvqa_tpu/train/schedules.py).

Each schedule is a plain function of the optimizer's update count
(``int`` -> ``float``), evaluated on the host: the optimizer multiplies by
its value, so reading the learning rate costs no device op.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]


def noam(learning_rate: float, warmup_steps: int) -> Schedule:
    """invsqrt/noam: lr * min(step^-0.5, step * warmup^-1.5) * warmup^0.5,
    which peaks at lr after warmup and then decays as 1/sqrt(step)."""
    def sched(step: int) -> float:
        s = float(max(int(step), 1))
        return learning_rate * min(s ** -0.5, s * warmup_steps ** -1.5) \
            * warmup_steps ** 0.5

    return sched


def warmup_linear(learning_rate: float, warmup_steps: int,
                  total_steps: int, floor: float = 1e-8) -> Schedule:
    """Linear warmup, then linear decay to ~0."""
    def sched(step: int) -> float:
        s = float(step)
        if s < warmup_steps:
            return learning_rate * s / max(warmup_steps, 1)
        return learning_rate * max(
            (total_steps - s) / max(total_steps - warmup_steps, 1), floor)

    return sched


def multi_step(learning_rate: float, milestones: Sequence[int],
               gamma: float = 0.5) -> Schedule:
    """MultiStepLR: lr * gamma^(number of passed milestones); milestones
    are in scheduler steps (make_optimizer converts epochs)."""
    def sched(step: int) -> float:
        return learning_rate * gamma ** sum(step >= m for m in milestones)

    return sched


def constant(learning_rate: float) -> Schedule:
    return lambda step: float(learning_rate)


def get_lr_schedule(decay: Optional[str], learning_rate: float,
                    total_steps: int = 0, warmup_ratio: float = 0.1,
                    milestones: Optional[Sequence[int]] = None,
                    gamma: float = 0.5) -> Schedule:
    """Schedule by name: ``constant``, ``multi_step``, ``linear``,
    ``invsqrt``."""
    if decay == "constant" or decay is None:
        return constant(learning_rate)
    if decay == "multi_step":
        return multi_step(learning_rate, milestones or [], gamma)
    warmup = max(int(warmup_ratio * total_steps), 1)
    if decay == "linear":
        return warmup_linear(learning_rate, warmup, total_steps)
    if decay == "invsqrt":
        return noam(learning_rate, warmup)
    raise ValueError(f"unknown decay {decay!r}")


def lr_value(decay: Optional[str], learning_rate: float, step: int,
             total_steps: int = 0, warmup_ratio: float = 0.1,
             milestones: Optional[Sequence[int]] = None,
             gamma: float = 0.5) -> float:
    """The learning rate at an optimizer update count."""
    return float(get_lr_schedule(decay, learning_rate, total_steps,
                                 warmup_ratio, milestones, gamma)(int(step)))
