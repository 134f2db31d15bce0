"""Config system: argparse defaults < JSON config file < explicit CLI flags
(counterpart of sasvqa_tpu/core/config.py: the same flags, JSON keys,
defaults and precedence).

Replicates the precedence semantics of the reference config system
(reference: src/configs/config.py:12-29 ``parse_with_config``): values in
the JSON file override argparse defaults, but flags passed explicitly on
the command line win over the JSON file.  Nested dict values are wrapped
so they support attribute access (``cfg.model.pretrained_model``,
``cfg.train_datasets[0].txt``), matching the reference's EasyDict usage.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Any, Dict, List, Optional


class ConfigDict(dict):
    """dict with recursive attribute access (EasyDict equivalent)."""

    def __init__(self, d: Optional[Dict[str, Any]] = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return ConfigDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(ConfigDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def parse_with_config(parsed_args: argparse.Namespace,
                      argv: Optional[List[str]] = None) -> ConfigDict:
    """Overlay the JSON config onto parsed args, respecting CLI overrides.

    Only parameters *not* explicitly given on the command line are
    overwritten by the config file (reference: src/configs/config.py:12-29).
    """
    args = ConfigDict(vars(parsed_args))
    argv = sys.argv[1:] if argv is None else argv
    if args.get("config") is not None:
        with open(args.config) as f:
            config_args = json.load(f)
        override_keys = {
            arg[2:].split("=")[0] for arg in argv if arg.startswith("--")
        }
        for k, v in config_args.items():
            if k not in override_keys:
                setattr(args, k, v)
    args.pop("config", None)
    return args


_ZERO_ONE_OPTIONS = [
    "fp16", "bf16", "pin_mem", "use_itm", "use_mlm", "debug", "freeze_cnn",
    "do_inference", "zero_eval",
]


def build_shared_parser(desc: str = "sasvqa_torch shared config") -> argparse.ArgumentParser:
    """Shared flags, mirroring the reference's SharedConfigs inventory
    (reference: src/configs/config.py:42-232) minus dead detectron2/CNN
    options, plus the JAX package's own (kept so that one config file
    drives both packages)."""
    # allow_abbrev=False: argparse prefix matching (e.g. --learning for
    # --learning_rate) would record the ABBREVIATED spelling in argv, so
    # parse_with_config's override_keys scan would miss it and the JSON
    # value would silently beat the explicit CLI flag — inverting the
    # documented CLI > JSON precedence (r3 review finding)
    p = argparse.ArgumentParser(description=desc, allow_abbrev=False)
    # debug
    p.add_argument("--debug", type=int, choices=[0, 1], default=0,
                   help="debug mode: break train loop after 3 steps, val after 5")
    p.add_argument("--data_ratio", type=float, default=1.0,
                   help="portion of train examples to use. Reference "
                        "quirk preserved: only the tgif-qa family "
                        "branch applies it (msvd/msrvtt loaders ignore "
                        "it — run_video_qa.py:98-101 lives in the "
                        "jsonl/else branch only)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of this many "
                        "train steps (starting at step 2, after the "
                        "first) into output_dir/trace; 0 = off")
    # required-ish
    p.add_argument("--output_dir", type=str, default=None,
                   help="dir for checkpoints & training meta")
    # data preprocessing
    p.add_argument("--max_txt_len", type=int, default=20, help="max text #tokens")
    p.add_argument("--max_img_size", type=int, default=448)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--max_n_example_per_group", type=int, default=2)
    # video
    p.add_argument("--fps", type=int, default=1)
    p.add_argument("--num_frm", type=int, default=3)
    p.add_argument("--nframe", type=int, default=4,
                   help="#frames sampled online per video by the collator")
    p.add_argument("--samp_policy", type=str, default="random",
                   choices=["uniform", "random", "single", "question-caption",
                            "importance"])
    p.add_argument("--train_n_clips", type=int, default=3)
    p.add_argument("--score_agg_func", type=str, default="mean",
                   choices=["mean", "max", "lse"])
    p.add_argument("--random_sample_clips", type=int, default=1, choices=[0, 1])
    # training
    p.add_argument("--train_batch_size", default=128, type=int)
    p.add_argument("--val_batch_size", default=128, type=int)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--stage_pixels_bf16", type=int, default=1,
                   choices=[0, 1],
                   help="stage pixel batches host->device as bf16 when "
                        "activations are bf16 (halves the dominant "
                        "transfer; the first conv casts to bf16 anyway). "
                        "0 keeps f32 staging.")
    p.add_argument("--stage_pixels_u8", type=int, default=0,
                   choices=[0, 1],
                   help="stage pixel batches as uint8 by inverting the "
                        "store's normalize affine (core/pixels.py): "
                        "half bf16's bytes, a quarter of f32's, "
                        "LOSSLESS for stage-A stores (the frames came "
                        "from the uint8 grid); models dequantize "
                        "in-jit.  Overrides --stage_pixels_bf16.")
    p.add_argument("--accum_grad_mean", type=int, default=1, choices=[0, 1],
                   help="1 (default): average gradients over the "
                        "accumulation window. 0: SUM them — the "
                        "reference's exact live behavior (its per-micro "
                        "loss.backward() never divides by K), which "
                        "scales the effective step by K.")
    p.add_argument("--scan_accum", type=int, default=1, choices=[0, 1],
                   help="accumulate gradients in-jit over K stacked "
                        "micro-batches with ONE optimizer update per "
                        "global step (default; ~10%% faster than the "
                        "0 = optax.MultiSteps per-micro fallback). "
                        "Checkpoints are NOT interchangeable across the "
                        "two settings (optimizer state trees differ); "
                        "keep the flag fixed across resume.")
    # deliberate divergence (opt-in, PARITY.md): bf16 Adam moments halve
    # the optimizer's HBM traffic (7 -> 5 f32-equivalent passes/param;
    # the adamw tail is at its measured bandwidth floor otherwise,
    # BASELINE.md "Tail irreducibility").  f32 keeps bitwise parity with
    # torch.optim.AdamW (tests/test_optimizer.py).  Checkpoints are NOT
    # interchangeable across settings (moment dtypes differ); keep the
    # flag fixed across resume.
    p.add_argument("--adamw_moment_dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="dtype Adam's mu/nu moments are STORED in "
                        "(EMA math stays f32). bf16 saves ~29%% of "
                        "optimizer-update HBM traffic at a ~2^-8 "
                        "relative moment-rounding cost; f32 (default) "
                        "is bitwise-parity with the reference.")
    p.add_argument("--learning_rate", default=5e-5, type=float)
    p.add_argument("--num_valid", default=20, type=int)
    p.add_argument("--min_valid_steps", default=100, type=int)
    p.add_argument("--save_steps_ratio", default=0.01, type=float)
    p.add_argument("--num_train_epochs", default=10, type=int)
    p.add_argument("--optim", default="adamw", type=str)
    p.add_argument("--betas", default=[0.9, 0.98], nargs=2, type=float)
    p.add_argument("--decay", default="constant",
                   choices=["linear", "invsqrt", "multi_step", "constant"])
    p.add_argument("--gamma", default=0.5, type=float,
                   help="multi_step decay factor")
    p.add_argument("--step_decay_epochs", type=int, nargs="+", default=None)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
    p.add_argument("--grad_norm", default=2.0, type=float)
    p.add_argument("--warmup_ratio", default=0.1, type=float)
    p.add_argument("--zero_eval", type=int, choices=[0, 1], default=0)
    # inference
    p.add_argument("--inference_model_step", default=-1, type=int)
    p.add_argument("--do_inference", default=0, type=int, choices=[0, 1])
    p.add_argument("--inference_split", default="val",
                   help="split --do_inference evaluates (reference "
                        "configs/config.py:202-204): 'val' scores against "
                        "ground truth; 'test*' assumes none — predictions "
                        "are written to output_dir/qa_results_{split}.json "
                        "without scoring")
    p.add_argument("--inference_txt_db", type=str, default=None)
    p.add_argument("--inference_img_db", type=str, default=None)
    p.add_argument("--inference_batch_size", type=int, default=64)
    p.add_argument("--inference_n_clips", type=int, default=1)
    # device
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fp16", type=int, choices=[0, 1], default=0)
    p.add_argument("--bf16", type=int, choices=[0, 1], default=1,
                   help="bf16 activations (replacement for fp16+GradScaler)")
    # deliberate divergence from the reference's DataLoader num_workers=4
    # default (run_video_qa.py:184): the collation pool is opt-in
    # (n_workers > 0 collates in that many spawned worker processes,
    # data/pipeline.CollatorPool)
    p.add_argument("--n_workers", type=int, default=0)
    p.add_argument("--pin_mem", type=int, choices=[0, 1], default=1)
    # device / mesh: one process a device, launched by torchrun
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs on the CPU (gloo between processes); "
                        "default: the GPU (NCCL)")
    p.add_argument("--mesh_shape", type=int, nargs="+", default=None,
                   help="device mesh shape, e.g. --mesh_shape 8 for dp=8; "
                        "its size is the number of processes (torchrun "
                        "--nproc_per_node); default: every process on one "
                        "data axis")
    p.add_argument("--mesh_axes", type=str, nargs="+", default=None,
                   help="mesh axis names matching --mesh_shape, from data "
                        "(gradient all-reduce), fsdp (FSDP2) and model "
                        "(tensor parallelism); default: ['data']")
    # config file overlay
    p.add_argument("--config", help="JSON config file")
    return p


def finalize_config(args: ConfigDict) -> ConfigDict:
    """Bool coercion + validation asserts (reference: src/configs/config.py:239-271)."""
    for option in _ZERO_ONE_OPTIONS:
        if option in args:
            setattr(args, option, bool(args[option]))

    assert args.gradient_accumulation_steps >= 1, (
        f"Invalid gradient_accumulation_steps: {args.gradient_accumulation_steps}")
    assert 1 >= args.data_ratio > 0, (
        f"--data_ratio should be (0, 1], got {args.data_ratio}")
    assert args.max_img_size > 0, "max_img_size must be > 0"
    if args.get("score_agg_func") == "lse" and args.get("loss_type") is not None:
        assert args.loss_type == "ce", (
            f"lse aggregation requires ce loss, not {args.loss_type}")
    shape, axes = args.get("mesh_shape"), args.get("mesh_axes")
    if axes is not None:
        if len(set(axes)) != len(axes) or \
                not set(axes) <= {"data", "fsdp", "model"}:
            raise ValueError(f"mesh_axes {list(axes)}: each of data, fsdp "
                             f"and model at most once")
    if shape is not None and len(shape) != len(axes or ["data"]):
        raise ValueError(f"mesh_shape {list(shape)} has {len(shape)} dims "
                         f"but mesh_axes {list(axes or ['data'])} name "
                         f"{len(axes or ['data'])}")
    return args


def get_video_qa_args(argv: Optional[List[str]] = None) -> ConfigDict:
    """Video-QA task config (reference: src/configs/config.py:291-334).

    Derives ``num_labels``/``loss_type`` from the task, with the same
    label-count floors as the reference (1000 for msvd/msrvtt, 1540 for
    frameqa, 5 for multiple-choice action/transition).
    """
    p = build_shared_parser("video QA config")
    p.add_argument("--task", type=str,
                   choices=["action", "transition", "frameqa", "msvd_qa",
                            "msrvtt_qa"])
    p.add_argument("--loss_type", type=str, default="ce")
    p.add_argument("--classifier", type=str, default="mlp",
                   choices=["mlp", "linear"])
    p.add_argument("--cls_hidden_scale", type=int, default=2)
    p.add_argument("--ans2label_path", type=str, default=None)

    parsed = p.parse_args(argv)
    args = finalize_config(parse_with_config(parsed, argv))

    num_answers = 1000
    if args.task in ["action", "transition"]:
        args.num_labels = 5
        args.loss_type = "ce"
    elif args.task == "frameqa":
        args.num_labels = max(num_answers, 1540)
        args.loss_type = "ce"
    elif args.task in ("msrvtt_qa", "msvd_qa"):
        args.num_labels = max(num_answers, 1000)
        args.loss_type = "ce"
    else:
        raise NotImplementedError(f"unknown task {args.task}")
    return args


def load_config(path: str, **overrides) -> ConfigDict:
    """Load a JSON config file directly (programmatic entry, no CLI)."""
    with open(path) as f:
        cfg = ConfigDict(json.load(f))
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
