"""Where a training update spends its time on the GPU.

    python3 -m sasvqa_torch.tools.profile_train
        [--shape git|blip|clip|vitl16] [--trace DIR]

Runs ``torch.profiler`` over one ``make_scan_train_step`` update at full
width (seeded random weights, bf16 activations, f32 params) after the
warm-up updates (the step's graph captured), at the train phases' shapes
of chip_smoke.py:

- ``git``: GIT-base, dropout 0.1 and attention dropout 0.1, 2
  micro-batches of 16 questions over 8 frames of 224x224, text length 32,
  S = 1608, AdamW;
- ``blip``: BLIP-base classifier (1000 labels, mlp head, head dropout
  0.1), 4 micro-batches of 8 questions over 4 frames of 384x384 (577
  tokens a frame), text length 20, Adam;
- ``clip``: CLIP ViT-B/16 classifier at configs/msvd_qa_base3.json's
  shape (1000 labels, mlp head, head dropout 0.1), 4 micro-batches of 8
  questions over 1 frame of 224x224 (the config's 'single' sampling),
  text length 20, Adam;
- ``vitl16``: GIT with the ViT-L/14 vision tower (the JAX package's
  stretch configuration), remat on, both dropouts 0.1, 2 micro-batches
  of 8 questions over 16 frames of 224x224 (257 tokens a frame), text
  length 32, S = 4144, AdamW.

Prints one JSON line: host wall ms (ending in a synchronize), the device
time of every CUDA kernel summed, the device busy share, the launch
count, the kernels that took the most device time, and the device time
of the kernel groups (the port's own kernels, GEMMs, the rest), the
port kernels' launch counts (``port_launches``; of them, those a
replay of the step's graph added from its capture and no wrapper saw:
``port_launches_replayed``) and the micros the step replayed from its
captured graph or ran eagerly (``micros``).  A second
line splits one micro-batch's time (host clock, ending in a synchronize)
into the vision tower's forward, the whole forward, forward+backward, the
pixel upload and the optimizer update.  ``--trace DIR`` also writes a
Chrome trace there.  ``--family`` is the older spelling of ``--shape``.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sasvqa_torch.models.presets import build_model
from sasvqa_torch.ops import _build
from sasvqa_torch.tools.profile_serve import profile_part
from sasvqa_torch.train.steps import (_LOSSES, MicroGraph,
                                      create_train_state,
                                      make_scan_train_step, micro_counts,
                                      reset_micro_counts)

SHAPES = {
    "git": dict(k_micro=2, batch=16, frames=8, img=224, text_len=32,
                family="git",
                cfg={"model": {"pretrained_model":
                               "microsoft/git-base-msrvtt-qa"}},
                optim={"optim": "adamw", "learning_rate": 2e-4,
                       "betas": [0.9, 0.98], "weight_decay": 1e-3,
                       "grad_norm": 5.0, "decay": "constant"}),
    "blip": dict(k_micro=4, batch=8, frames=4, img=384, text_len=20,
                 family="classifier",
                 cfg={"model": {"pretrained_model": "Salesforce/blip-base",
                                "hidden_dropout_prob": 0.1},
                      "num_labels": 1000, "classifier": "mlp",
                      "cls_hidden_scale": 2},
                 optim={"optim": "adam", "learning_rate": 2e-4,
                        "betas": [0.9, 0.999], "grad_norm": 5.0,
                        "decay": "constant"}),
}
SHAPES["clip"] = dict(
    SHAPES["blip"], frames=1, img=224,
    cfg=dict(SHAPES["blip"]["cfg"], model={
        "pretrained_model": "openai/clip-vit-base-patch16",
        "hidden_dropout_prob": 0.1}))
SHAPES["vitl16"] = dict(
    SHAPES["git"], batch=8, frames=16,
    cfg={"model": {"pretrained_model": "microsoft/git-large-msrvtt-qa",
                   "hidden_dropout_prob": 0.1,
                   "attention_probs_dropout_prob": 0.1},
         "remat": True})
# kernel-name fragments of the port's hand-written kernels
PORT_KERNELS = ("flash", "rowsum_product")


def _batch(shape, seed: int):
    rng = np.random.default_rng(seed)
    k, b, l = shape["k_micro"], shape["batch"], shape["text_len"]
    ids = rng.integers(1000, 2000, (k, b, l))
    mask = np.ones_like(ids)
    mask[:, :, l * 5 // 8:] = 0
    if shape["family"] == "git":
        labels = np.where(mask == 1, ids, 0)
        labels[:, :, :8] = -100
    else:
        labels = rng.integers(0, shape["cfg"]["num_labels"], (k, b))
    px = rng.standard_normal((k, b, shape["frames"], shape["img"],
                              shape["img"], 3), dtype=np.float32)
    return {"text_input_ids": ids, "text_attention_mask": mask,
            "visual_inputs": px, "labels": labels}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", "--family", choices=sorted(SHAPES),
                   default="git")
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)
    shape = SHAPES[args.shape]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, model = build_model(shape["cfg"], dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, shape["optim"], total_steps=100)
    step = make_scan_train_step(shape["k_micro"], shape["family"])
    batch = _batch(shape, 0)

    def update():
        nonlocal state
        state, metrics = step(state, batch, 0)
        metrics["loss"].item()

    # warm-up: the kernels' builds, the step's eager warm-up micros and
    # the capture of its graph
    for _ in range(-(-(MicroGraph.WARMUP + 1) // shape["k_micro"])):
        update()
    _build.reset_launch_counts()
    reset_micro_counts()
    row = profile_part("train_update", update, args.trace, top=12,
                       keep_all=True)
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    groups = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for item in row["top_all"]:
        name = item["kernel"]
        key = ("port_kernels" if any(t in name for t in PORT_KERNELS) else
               "gemm" if any(t in name.lower() for t in
                             ("gemm", "cutlass", "sm90_xmma", "nvjet"))
               else "other")
        groups[key] += item["ms"]
    del row["top_all"]
    row.update(shape=args.shape, k_micro=shape["k_micro"],
               batch_size=shape["batch"], frames=shape["frames"],
               img=shape["img"], group_ms=groups, port_launches=launches,
               port_launches_replayed={k: v for k, v in
                                       _build.replayed_counts.items() if v},
               micros=dict(micro_counts))
    print(json.dumps(row), flush=True)
    print(json.dumps(_parts(state, batch, shape)), flush=True)
    return 0


def _wall_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _parts(state, batch, shape):
    """Host-clock ms of the pieces of one micro-batch and of the update."""
    model, dev = state.model, torch.device("cuda")
    micro = {k: batch[k][0] for k in ("text_input_ids",
                                       "text_attention_mask",
                                       "visual_inputs", "labels")}
    px = torch.from_numpy(micro["visual_inputs"]).to(dev)
    loss_fn = _LOSSES[shape["family"]]

    def loss():
        gen = torch.Generator(device=dev).manual_seed(0)
        return loss_fn(model, micro, gen, dev)[0]

    def vision():
        with torch.no_grad():
            if shape["family"] == "git":
                model.encode_frames(px)
            else:
                model.vis_model(px.to(model.dtype).flatten(0, 1))

    def forward():
        with torch.no_grad():
            loss()

    def fwd_bwd():
        loss().backward()

    grads = [p.grad for p in state.optimizer.params]
    # the last item applies further updates: the state is not used after
    return {"part": "micro_split", "vision_fwd_ms": _wall_ms(vision),
            "fwd_ms": _wall_ms(forward), "fwd_bwd_ms": _wall_ms(fwd_bwd),
            "h2d_pixels_ms": _wall_ms(lambda: torch.from_numpy(
                micro["visual_inputs"]).to(dev)),
            "optimizer_update_ms": _wall_ms(
                lambda: state.optimizer.update(grads))}


if __name__ == "__main__":
    raise SystemExit(main())
