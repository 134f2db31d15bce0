"""Zero-data quickstart: synthetic dataset -> train -> validate in one
command (counterpart of sasvqa_tpu/tools/quickstart.py).

Generates the deterministic synthetic fixtures of ``data/synthetic.py``,
writes a ready config and drives the real runner
(``tasks/run_video_qa.main``) end to end on a tiny model: training steps,
periodic validation, snapshots and the metrics JSONL.

    python -m sasvqa_torch.tools.quickstart                  # CLIP classifier
    python -m sasvqa_torch.tools.quickstart --family git     # generative path
    python -m sasvqa_torch.tools.quickstart --family mc      # TGIF-QA action MC
    python -m sasvqa_torch.tools.quickstart --platform cpu   # on the CPU
    torchrun --nproc_per_node 2 -m sasvqa_torch.tools.quickstart \
        --mesh 2 --platform cpu                             # 2 ranks (gloo)

It runs on the GPU unless ``--platform cpu`` is given.  Everything lands
under ``--root`` (default: ``sasvqa_quickstart`` in the temporary
directory): ``data/`` fixtures, ``cfg.json``, and ``out/`` with
``log/scalars.jsonl`` and the checkpoints, the layout a real run
produces.  ``--mesh N`` trains data-parallel over the N processes of a
``torchrun --nproc_per_node N`` launch (rank 0 writes the fixtures); N
more than the processes raises the loop's ValueError.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Callable, Optional

from sasvqa_torch.data.frame_store import FrameStoreReader, FrameStoreWriter


def build_config(root: str, paths: dict, family: str, mesh: int,
                 epochs: int, platform: Optional[str] = None) -> str:
    """Write the quickstart config of ``family`` under ``root``; returns
    its path.  ``platform`` "cpu" runs on the CPU, None on the GPU."""
    model = {"pretrained_model": "tiny-git", "vocab_size": 512,
             "img_len": 2} if family == "git" else \
            {"pretrained_model": "tiny-clip", "vocab_size": 512,
             "txt_output_size": 32, "hidden_dropout_prob": 0.1}
    cfg = {
        "task": "action" if family == "mc" else "msvd_qa",
        "train_datasets": [{"name": "synthetic", "txt": paths["train"],
                            "img": paths["h5"]}],
        "val_datasets": [{"name": "synthetic", "txt": paths["val"],
                          "img": paths["h5"]}],
        "inference_txt_db": paths["test"],
        "inference_img_db": paths["h5"],
        "vid_mapping": paths["vidmapping"],
        "model": model,
        "img_size": 32,
        "nframe": 2,
        "samp_policy": "uniform",
        "max_n_example_per_group": 1,
        "train_batch_size": 2,
        "val_batch_size": 4,
        "inference_batch_size": 4,
        "gradient_accumulation_steps": 2,
        "num_train_epochs": epochs,
        "min_valid_steps": 4,
        "num_valid": 2,
        "learning_rate": 1e-4,
        "decay": "constant",
        "optim": "adamw",
        "seed": 0,
        "platform": platform,
        "mesh_shape": [mesh],
        "output_dir": os.path.join(root, "out"),
        "max_txt_len": 16,
    }
    if family == "git":
        cfg.update(gen_max_text_len=24, gen_max_new_tokens=6)
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def main(argv=None, *, writer: Callable[..., Any] = FrameStoreWriter,
         open_store: Callable[[str], Any] = FrameStoreReader):
    """``writer`` builds the synthetic frame store and ``open_store``
    opens it for the loop (default: HDF5 both; an in-memory pair where
    there is no h5py)."""
    p = argparse.ArgumentParser(
        description="synthetic end-to-end demo run (no dataset needed)")
    p.add_argument("--family", default="clip",
                   choices=["clip", "git", "mc"],
                   help="clip: dual-encoder + cross-attn classifier; "
                        "git: generative causal-LM QA; mc: TGIF-QA "
                        "action multiple-choice")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "sasvqa_quickstart"))
    p.add_argument("--mesh", type=int, default=1,
                   help="data-parallel mesh size: the number of processes "
                        "(torchrun --nproc_per_node)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    args = p.parse_args(argv)

    from sasvqa_torch.parallel.mesh import barrier, init_distributed, rank
    init_distributed(args.platform)
    os.makedirs(args.root, exist_ok=True)
    data_root = os.path.join(args.root, "data")
    cfg_path = os.path.join(args.root, "cfg.json")
    if rank() == 0:     # one writer of the fixtures and the config
        if args.family == "mc":
            from sasvqa_torch.data.synthetic import make_synthetic_mc_dataset
            paths = make_synthetic_mc_dataset(data_root, num_videos=4,
                                              stored_frames=8, img_hw=32,
                                              writer=writer)
        else:
            from sasvqa_torch.data.synthetic import make_synthetic_dataset
            paths = make_synthetic_dataset(data_root, num_videos=4,
                                           stored_frames=8, img_hw=32,
                                           questions_per_video=2,
                                           writer=writer)
        cfg_path = build_config(args.root, paths, args.family, args.mesh,
                                args.epochs, args.platform)
    barrier()
    print(f"[quickstart] synthetic data: {data_root}")
    print(f"[quickstart] config:         {cfg_path}")

    from sasvqa_torch.tasks.run_video_qa import main as run_main
    task = "action" if args.family == "mc" else "msvd_qa"
    result = run_main(["--task", task, "--config", cfg_path],
                      open_store=open_store)

    print(f"[quickstart] final train loss: {result['train_loss']:.4f} "
          f"after {result['global_step']} steps")
    print(f"[quickstart] val overall_acc:  "
          f"{result['val'].get('overall_acc')}")
    out = os.path.join(args.root, "out")
    print(f"[quickstart] scalars: {os.path.join(out, 'log/scalars.jsonl')}")
    print(f"[quickstart] checkpoints: {os.path.join(out, 'ckpt')}")
    return result


if __name__ == "__main__":
    main()
