"""One rank of a gloo process group for tests/test_torch_multiprocess.py.

    python _torch_mp_worker.py <rank> <world> <store> <job.json> <out.json>

Joins the group through a ``file://`` store (``RANK``/``WORLD_SIZE``/
``LOCAL_RANK`` set as torchrun sets them), runs the job and writes its
result as JSON.  Jobs: ``main`` (``run_video_qa.main(argv)``) and
``tp_grads`` (tiny-git's loss and gradients unsharded and under tensor
parallelism, then train updates with dropout on).  It imports no JAX.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch


def run_main(job):
    """``run_video_qa.main(argv)``; ``init`` names a saved state dict the
    model starts from (another package's init)."""
    from sasvqa_torch.tasks import run_video_qa
    if job.get("init"):
        state = torch.load(job["init"], weights_only=True)
        build = run_video_qa.build_model

        def build_from_state(cfg, **kw):
            family, model = build(cfg, **kw)
            model.load_state_dict(state)
            return family, model

        run_video_qa.build_model = build_from_state
    res = run_video_qa.main(job["argv"])
    return {"global_step": int(res["global_step"]),
            "train_loss": float(res["train_loss"]),
            "val": res["val"], "test": res["test"]}


def _tiny_git_batch(seed=0, b=4, lq=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 500, (b, lq)).astype(np.int64)
    mask = np.ones((b, lq), np.int64)
    mask[1, 6:] = 0
    labels = np.where(rng.random((b, lq)) < 0.5, ids, -100)
    px = rng.normal(size=(b, 2, 32, 32, 3)).astype(np.float32)
    return {"text_input_ids": ids, "text_attention_mask": mask,
            "visual_inputs": px, "labels": labels}


def run_tp_grads(job):
    """Loss and gradients of tiny-git without and with tensor parallelism
    on the same batch (dropout off), then two train updates with dropout
    on; returns the largest differences and the replicated leaves'
    digests."""
    import torch.distributed as dist
    from sasvqa_torch.models.presets import build_model
    from sasvqa_torch.parallel.mesh import (full, is_dtensor, make_mesh,
                                            param_sharding_for_mesh)
    from sasvqa_torch.train import steps

    def model(dropout):
        cfg = {"model": {"pretrained_model": "tiny-git",
                         "vocab_size": job["vocab_size"],
                         "hidden_dropout_prob": dropout,
                         "attention_probs_dropout_prob": dropout},
               "img_size": 32}
        return build_model(cfg, device="cpu")[1]

    batch = _tiny_git_batch()
    inputs = (torch.from_numpy(batch["text_input_ids"]),
              torch.from_numpy(batch["text_attention_mask"]),
              torch.from_numpy(batch["visual_inputs"]))
    labels = torch.from_numpy(batch["labels"])
    ref = model(0.0)
    loss_ref = ref(*inputs, labels=labels)["loss"]
    loss_ref.backward()
    grads_ref = {n: p.grad for n, p in ref.named_parameters()}

    tp = model(0.0)
    mesh = make_mesh([dist.get_world_size()], ["model"], "cpu")
    plan = param_sharding_for_mesh(tp, mesh)
    loss_tp = tp(*inputs, labels=labels)["loss"]
    loss_tp.backward()
    grad_err = max(float((full(p.grad) - grads_ref[n]).abs().max())
                   for n, p in tp.named_parameters())
    n_sharded = sum(is_dtensor(p) and not p.placements[0].is_replicate()
                    for p in tp.parameters())
    qkv = tp.layer_0.attention.qkv.weight
    # a DTensor never reaches the attention kernels or their plain versions
    from sasvqa_torch.ops.flash_attention import flash_attention
    from sasvqa_torch.ops.git_flash import git_flash_attention
    refused = []
    x = qkv.new_zeros(())          # a DTensor on the model mesh
    for fn, args in ((git_flash_attention, (x, x, x, x, 1)),
                     (flash_attention, (x, x, x))):
        try:
            fn(*args)
        except TypeError as e:
            refused.append("plain tensors" in str(e))

    # dropout on: two updates through the train step
    drop = model(0.1)
    plan = param_sharding_for_mesh(drop, mesh)
    state = steps.create_train_state(drop, {"learning_rate": 1e-3},
                                     total_steps=4, device="cpu", plan=plan)
    step = steps.make_git_train_step("cpu")
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch, 7)
        losses.append(float(metrics["loss"]))
    replicated = {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                  for n, p in drop.named_parameters() if not is_dtensor(p)}
    return {"loss_ref": float(loss_ref), "loss_tp": float(loss_tp),
            "grad_err": grad_err, "n_sharded": n_sharded,
            "qkv_local_shape": list(qkv.to_local().shape),
            "heads": tp.layer_0.attention.num_heads,
            "drop_losses": losses, "replicated": replicated,
            "refused": refused}

def run_quickstart(job):
    from sasvqa_torch.tools.quickstart import main
    res = main(job["argv"])
    return {"global_step": int(res["global_step"]),
            "train_loss": float(res["train_loss"]), "val": res["val"]}


JOBS = {"main": run_main, "tp_grads": run_tp_grads,
        "quickstart": run_quickstart}


def main():
    rank, world, store, job_path, out_path = sys.argv[1:6]
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    torch.set_num_threads(1)
    # no TensorBoard mirror of the scalar log: its import loads TensorFlow
    # (about 10 s a process) and the tests read scalars.jsonl
    sys.modules["torch.utils.tensorboard"] = None
    from sasvqa_torch.parallel.mesh import init_distributed
    init_distributed("cpu", init_method=f"file://{store}", timeout_s=240)
    with open(job_path) as f:
        job = json.load(f)
    result = JOBS[job["kind"]](job)
    with open(out_path, "w") as f:
        json.dump(result, f)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
