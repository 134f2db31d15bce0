"""Per-configuration train-step decomposition for the non-flagship shapes
(counterpart of sasvqa_tpu/tools/profile_config.py):

    python3 -m sasvqa_torch.tools.profile_config [clip1 mif2 vitl16]
        [--iters 8] [--platform cpu]

- ``clip1``: configs/msvd_qa_base3.json's class, the CLIP ViT-B/16
  classifier (1000 labels), B=8, 1 frame of 224x224, text length 32;
- ``mif2``: msrvtt_qa_base2/3's class, GIT-base, B=16, 2 frames
  (S = 2*197 + 32 = 426: the dense route, below the git-flash kernels'
  512);
- ``vitl16``: GIT with the ViT-L/14 tower, B=8, 16 frames (S = 16*257 +
  32 = 4144: K1, K2 and, in the updates, K4), including the remat-policy
  sweep: one update at full recompute (``remat`` with no policy), the
  named policies ``dots_with_no_batch_dims_saveable`` and
  ``dots_saveable``, and no remat, each with its ms and peak memory.  A
  policy that does not fit on the card reports its
  ``torch.cuda.OutOfMemoryError`` in its row.

Probes are those of ``profile_step`` (same timing: a warm-up call, then
``--iters`` calls by CUDA events ending in a synchronize) at each
configuration's shape, plus clip1's text tower and fusion head, and the
AdamW update beside its memory-bound floor (7 f32 passes over the
parameters: read param, grad, mu, nu; write param, mu, nu).  Seeded
random weights, bf16 activations, f32 params.  One JSON line a probe.
Runs on the GPU unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.models.fusion import AnswerClassifier
from sasvqa_torch.models.presets import build_model
from sasvqa_torch.ops import _build
from sasvqa_torch.tools import profile_step as ps
from sasvqa_torch.train.steps import (create_train_state,
                                      make_classifier_train_step)

MIF2 = ps.GitShape("microsoft/git-base-msrvtt-qa", batch=16, frames=2,
                   text_len=32)
VITL16 = ps.GitShape("microsoft/git-large-msrvtt-qa", batch=8, frames=16,
                     text_len=32, remat=True)
# (label, remat, remat_policy) of the sweep
REMAT_SWEEP = (("full_recompute", True, None),
               ("dots_with_no_batch_dims_saveable", True,
                "dots_with_no_batch_dims_saveable"),
               ("dots_saveable", True, "dots_saveable"),
               ("no_remat", False, None))


@dataclasses.dataclass(frozen=True)
class ClipShape:
    model: str
    batch: int
    frames: int
    text_len: int
    num_labels: int = 1000

    def cfg(self) -> Dict[str, Any]:
        return {"model": {"pretrained_model": self.model},
                "num_labels": self.num_labels}


CLIP1 = ClipShape("openai/clip-vit-base-patch16", batch=8, frames=1,
                  text_len=32)


# ---- clip1 ----------------------------------------------------------------

def _clip_batch(s: ClipShape, img: int, vocab: int, dev: torch.device):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, min(1000, vocab), (s.batch, s.text_len))
    return {"text_input_ids": torch.from_numpy(ids).long().to(dev),
            "text_attention_mask": torch.ones(s.batch, s.text_len,
                                              dtype=torch.int32, device=dev),
            "visual_inputs": torch.from_numpy(rng.standard_normal(
                (s.batch, s.frames, img, img, 3),
                dtype=np.float32)).to(dev),
            "labels": torch.from_numpy(rng.integers(
                0, s.num_labels, (s.batch,))).long().to(dev)}


def _clip_model(s: ClipShape, dev: torch.device):
    _, model = build_model(s.cfg(), dtype=torch.bfloat16, device=dev)
    batch = _clip_batch(s, model.vision_config.image_size,
                        model.text_config.vocab_size, dev)
    return model.train(), batch


def clip_step(s: ClipShape, dev: torch.device):
    model, batch = _clip_model(s, dev)
    state = create_train_state(model, ps.OPTIM, 1000, device=dev)
    step = make_classifier_train_step(dev)

    def fn():
        nonlocal state
        state, metrics = step(state, batch, 0)
        return metrics["loss"]

    return fn, None


def clip_vis_tower(s: ClipShape, dev: torch.device):
    """The projected vision tower (the classifier reads image_embeds)."""
    model, batch = _clip_model(s, dev)
    enc = model.vis_model
    params = list(enc.parameters())
    flat = batch["visual_inputs"].flatten(0, 1)
    v = model.vision_config
    tokens = s.batch * s.frames * ((v.image_size // v.patch_size) ** 2 + 1)

    def fn():
        _, _, emb = enc(flat)
        ps._sgd(params, torch.autograd.grad((emb.float() ** 2).mean(),
                                            params))

    return fn, 3 * 2 * tokens * v.num_layers * (
        4 * v.hidden_size ** 2 + 2 * v.hidden_size * v.intermediate_size)


def clip_txt_tower(s: ClipShape, dev: torch.device):
    model, batch = _clip_model(s, dev)
    enc = model.txt_model
    params = list(enc.parameters())
    t = model.text_config

    def fn():
        h, _ = enc(batch["text_input_ids"], batch["text_attention_mask"])
        ps._sgd(params, torch.autograd.grad((h.float() ** 2).mean(),
                                            params))

    return fn, 3 * 2 * s.batch * s.text_len * t.num_layers * (
        4 * t.hidden_size ** 2 + 2 * t.hidden_size * t.intermediate_size)


def clip_fusion(s: ClipShape, dev: torch.device):
    """The cross-attention fusion head and classifier, with the gradient
    of the text states."""
    model, batch = _clip_model(s, dev)
    d = model.text_config.hidden_size
    head = AnswerClassifier(d, s.num_labels, dtype=torch.bfloat16).to(
        dev).train()
    params = list(head.parameters())
    rng = np.random.default_rng(0)
    txt_h = ps._leaf(rng.standard_normal((s.batch, s.text_len, d),
                                         dtype=np.float32), dev,
                     torch.bfloat16)
    vis = torch.from_numpy(rng.standard_normal(
        (s.batch, s.frames, d), dtype=np.float32)).to(dev, torch.bfloat16)
    mask = batch["text_attention_mask"]

    def fn():
        logits = head(txt_h, mask, vis)
        ps._sgd([txt_h] + params, torch.autograd.grad(
            (logits ** 2).mean(), [txt_h] + params))

    return fn, None


def clip1(iters: int, device: DeviceLike = "cuda", shape: ClipShape = CLIP1,
          emit=lambda row: None) -> List[Dict[str, Any]]:
    dev = resolve_device(device)
    rows = []
    for name, build, n in (("step", clip_step, iters),
                           ("vis_tower", clip_vis_tower, iters),
                           ("txt_tower", clip_txt_tower, iters * 4),
                           ("fusion", clip_fusion, iters * 4),
                           ("adamw", ps.probe_adamw, iters * 4)):
        rows.append(ps.measure(name, lambda: build(shape, dev), n, dev,
                               config="clip1"))
        emit(rows[-1])
    return rows


# ---- mif2 and vitl16 --------------------------------------------------------

def mif2(iters: int, device: DeviceLike = "cuda",
         shape: ps.GitShape = MIF2, emit=lambda row: None
         ) -> List[Dict[str, Any]]:
    return ps.run(shape, ("step", "vis_tower", "txt_stack", "logits",
                          "adamw"), iters, device,
                  emit=emit, config="mif2")


def remat_row(label: str, s: ps.GitShape, updates: int,
              dev: torch.device,
              warmed: Callable[[torch.nn.Module], None] = lambda m: None,
              **extra) -> Dict[str, Any]:
    """One policy of the sweep at ``s``: GIT from ``git_update``, one
    warm-up update, then ``updates`` timed updates (``profile_step.measure``:
    ms an update by CUDA events, peak memory of build and run).  The row
    also holds the warm-up update's loss (``first_loss``) and the kernels'
    launches; ``warmed(model)`` sees the model just after the warm-up
    update, its parameters' ``.grad`` holding that update's gradients.  An
    OOM is reported in the row."""
    losses: List[torch.Tensor] = []

    def build():
        model, update = ps.git_update(s, dev)

        def fn():
            losses.append(update())
            if len(losses) == 1:
                warmed(model)

        return fn, ps.step_flop(s)

    before = dict(_build.launch_counts)
    head = {"policy": label, "remat": s.remat,
            "remat_policy": s.remat_policy, "batch": s.batch, **extra}
    try:
        row = ps.measure("remat_update", build, updates, dev, **head)
        row["first_loss"] = float(losses[0])
        row["qa_pairs_per_s"] = s.batch / (row["ms"] / 1e3)
    except torch.cuda.OutOfMemoryError as e:
        row = {"probe": "remat_update", **head, "error":
               f"{type(e).__name__}: {str(e).splitlines()[0]}"}
    row["launches"] = {k: n - before.get(k, 0)
                       for k, n in _build.launch_counts.items()
                       if n - before.get(k, 0)}
    del losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def remat_sweep(shape: ps.GitShape, updates: int, device: DeviceLike,
                emit=lambda row: None, **extra) -> List[Dict[str, Any]]:
    """One ``remat_row`` a policy of REMAT_SWEEP at ``shape``; an OOM is
    reported in its row and the sweep goes on."""
    dev = resolve_device(device)
    rows = []
    for label, remat, policy in REMAT_SWEEP:
        rows.append(remat_row(label, dataclasses.replace(
            shape, remat=remat, remat_policy=policy), updates, dev, **extra))
        emit(rows[-1])
    return rows


def vitl16(iters: int, device: DeviceLike = "cuda",
           shape: ps.GitShape = VITL16, emit=lambda row: None
           ) -> List[Dict[str, Any]]:
    n = max(iters // 2, 2)
    rows = remat_sweep(shape, n, device, emit=emit, config="vitl16")
    return rows + ps.run(shape, ("txt_flash", "txt_stack", "adamw"), n,
                         device, emit=emit, config="vitl16")


CONFIGS: Dict[str, Callable[..., List[Dict[str, Any]]]] = {
    "clip1": clip1, "mif2": mif2, "vitl16": vitl16}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs="*",
                   help=f"any of {sorted(CONFIGS)} (default: all)")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    args = p.parse_args(argv)
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        p.error(f"unknown configs {unknown}; known: {sorted(CONFIGS)}")
    dev = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"device": torch.cuda.get_device_name(dev)}),
              flush=True)
    for name in args.configs or list(CONFIGS):
        CONFIGS[name](args.iters, dev,
                      emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
