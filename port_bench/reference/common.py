"""What every plain reference shares: seeds, the f32 arithmetic (and
the float8 control's), and the optimizer.  Nothing here imports the
system under test."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

_M64 = (1 << 64) - 1
FP8_MAX = 448.0


def fold_in(seed: int, n: int) -> int:
    """A generator seed from (seed, n): the splitmix64 finalizer."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(n) + 1) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Full f32 products inside (TF32 off for matmuls and cuDNN), the
    process's settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax / 448), back in
    f32; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return x + (q - x.detach())


class Arith:
    """Matrix products in f32, optionally on float8-rounded operands."""

    def __init__(self, quant: bool = False):
        self.quant = quant

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fake_fp8(x) if self.quant else x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


class AdamW:
    """Adam with decoupled weight decay on 2-D and larger leaves, after
    clipping the gradients by their global norm when it reaches
    ``max_norm``; ``weight_decay`` 0 is plain Adam.  A constant learning
    rate (the configurations' multi-step schedule does not step in the
    runs compared)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Tuple[float, float], weight_decay: float,
                 max_norm: float, eps: float = 1e-8):
        self.params = params
        self.lr, (self.b1, self.b2) = lr, betas
        self.wd, self.max_norm, self.eps = weight_decay, max_norm, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        if self.max_norm > 0 and norm >= self.max_norm:
            return {k: g * (self.max_norm / norm) for k, g in grads.items()}
        return grads

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            p = self.params[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps)
            if self.wd and p.dim() >= 2:
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)
