"""Video-QA training/eval entry point for the GIT family on one device
(counterpart of sasvqa_tpu/tasks/run_video_qa.py):

    python -m sasvqa_torch.tasks.run_video_qa --task msvd_qa \
        --config configs/msvd_qa_base.json

The same config files drive it, with the JAX package's flags, step math
(reference run_video_qa.py:424-435), validation cadence, answer vocabulary
and metrics.  It runs on the GPU unless the config sets
``"platform": "cpu"``.  Not ported yet (each raises
``NotImplementedError``; ROADMAP.md lists them): the classifier and
multiple-choice families, a ``mesh_shape`` of more than one device,
multi-process training, ``n_workers`` > 0 and
``model.pretrained_weights``.
"""

from __future__ import annotations

import math
import os
import signal
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sasvqa_torch.core.checkpoint import (ModelSaver, TrainingRestorer,
                                          save_training_meta)
from sasvqa_torch.core.config import get_video_qa_args
from sasvqa_torch.core.device import resolve_device
from sasvqa_torch.core.logging import (LOGGER, TB_LOGGER, RunningMeter,
                                       add_log_to_file)
from sasvqa_torch.core.rng import set_random_seed
from sasvqa_torch.data.annotations import (build_common_answer_dict,
                                           evaluate_qa, group_datalist,
                                           load_datalist)
from sasvqa_torch.data.dataset import (GITCollator, VideoQADataset,
                                       make_collator, pixel_dtype_for)
from sasvqa_torch.data.frame_store import FrameStoreReader, load_vidmapping
from sasvqa_torch.data.pipeline import (CollatorPool, DevicePrefetcher,
                                        eval_batch_plan, infinite_batches,
                                        stack_microbatches)
from sasvqa_torch.data.tokenization import (WordPieceTokenizer,
                                            make_test_wordpiece)
from sasvqa_torch.models.presets import build_model
from sasvqa_torch.train import steps as train_steps
from sasvqa_torch.utils.basic import get_rounded_percentage, save_json

_NOT_PORTED = "is not ported yet (see ROADMAP.md)"


def build_tokenizer(cfg: Mapping[str, Any], family: str):
    tok_dir = cfg.get("tokenizer_dir")
    if family == "clip":
        raise NotImplementedError(
            "the CLIP BPE tokenizer comes with the classifier families")
    if tok_dir:
        vocab_txt = os.path.join(tok_dir, "vocab.txt")
        if os.path.exists(vocab_txt):
            return WordPieceTokenizer.from_vocab_file(vocab_txt)
        raise FileNotFoundError(f"no vocab.txt under {tok_dir}")
    LOGGER.warning("no tokenizer_dir configured; using the built-in test "
                   "WordPiece vocab (synthetic runs only)")
    return make_test_wordpiece()


def decode_answers(tokenizer, generated: np.ndarray,
                   ans2label: Dict[str, int]) -> Tuple[List[int], List[str]]:
    """Generated ids -> answer text -> label of its last word
    (reference run_video_qa.py:325-326)."""
    preds, strs = [], []
    for row in generated:
        text = tokenizer.decode(row, skip_special_tokens=True).strip()
        strs.append(text)
        word = text.split()[-1] if text.split() else ""
        preds.append(ans2label.get(word, -1))
    return preds, strs


def setup_datasets(cfg, ans2label, *,
                   open_store: Callable[[str], Any] = FrameStoreReader):
    """(train, val, test) datasets.  ``open_store(path)`` opens a frame
    store; the default reads HDF5, any object with
    :class:`FrameStoreReader`'s methods will do."""
    def make(split_txt, img, is_train):
        datalist = load_datalist(cfg.task, split_txt,
                                 data_ratio=cfg.data_ratio if is_train
                                 else 1.0)
        grouped = group_datalist(
            datalist, max_n_example_per_group=cfg.max_n_example_per_group,
            is_train=is_train)
        return VideoQADataset(cfg.task, grouped, open_store(img),
                              load_vidmapping(cfg.vid_mapping), ans2label,
                              is_train=is_train)

    train = make(cfg.train_datasets[0].txt, cfg.train_datasets[0].img, True)
    # reference quirk kept: val reuses the train store (run_video_qa.py:220)
    val = make(cfg.val_datasets[0].txt, cfg.train_datasets[0].img, False)
    test = make(cfg.inference_txt_db, cfg.inference_img_db, False)
    return train, val, test


def validate(dataset, collator, cfg, tokenizer, ans2label,
             eval_step: Callable[[Dict[str, Any]], torch.Tensor],
             eval_score: bool = True, tag: str = "valid") -> Dict[str, Any]:
    """Generative evaluation (reference validate, run_video_qa.py:283-387):
    greedy answers for every question of ``dataset``, scored by
    :func:`evaluate_qa`.

    'random'-policy frame draws are seeded per (group, clip), so a
    checkpoint scores the same at any eval batch size or plan padding.
    With ``inference_n_clips`` > 1 each question is answered from that
    many frame samples and the answers are majority-voted (ties go to the
    first clip).  One batch is in flight: batch i is dispatched before
    batch i-1's answers are decoded."""
    st = time.time()
    qa_results: List[Dict[str, Any]] = []
    n_ex = 0
    # reference: --do_inference evaluates at inference_batch_size, normal
    # validation at val_batch_size (run_video_qa.py:154-157)
    eval_bs = max(int(cfg.inference_batch_size if cfg.get("do_inference")
                      else cfg.val_batch_size), 1)
    ensemble = int(cfg.get("inference_n_clips", 1))

    def clip_rngs(idx, clip: int):
        return [np.random.default_rng((cfg.seed, int(i), clip)) for i in idx]

    def stage(batch):
        for k in DevicePrefetcher.HOST_KEYS:
            batch.pop(k, None)
        return batch

    def dispatch(idx_p, n_real_groups):
        gqids = [e["question_id"] for i in idx_p
                 for e in dataset.datalist[int(i)][1]]
        n_real = sum(len(dataset.datalist[int(i)][1])
                     for i in idx_p[:n_real_groups])
        # one read per video for every clip, and one get_group outcome
        items = [dataset.get_group(int(i)) for i in idx_p]
        raw = collator(items, rng=clip_rngs(idx_p, 0))
        if raw.get("question_ids") != gqids:
            raise RuntimeError("eval prediction attribution drift")
        outs = [eval_step(stage(raw))]
        # extra clips re-run only the collator (frame re-sampling lives
        # there) on the items read above
        outs += [eval_step(stage(collator(items, rng=clip_rngs(idx_p, c))))
                 for c in range(1, ensemble)]
        return gqids, n_real, outs

    def consume(pending):
        nonlocal n_ex
        gqids, n_real, outs = pending
        per_clip = [decode_answers(tokenizer, o.cpu().numpy()[:n_real],
                                   ans2label) for o in outs]
        for i, qid in enumerate(gqids[:n_real]):
            if ensemble > 1:
                votes = [preds[i] for preds, _ in per_clip]
                lbl = Counter(votes).most_common(1)[0][0]
                s = next(strs[i] for preds, strs in per_clip
                         if preds[i] == lbl)
            else:
                lbl, s = per_clip[0][0][i], per_clip[0][1][i]
            qa_results.append(dict(question_id=qid, answer=lbl,
                                   answer_str=s,
                                   data=dataset.qid2data[qid]))
        n_ex += n_real

    in_flight = None
    for b_idx, (idx_p, n_real_groups) in enumerate(
            eval_batch_plan(len(dataset), eval_bs)):
        cur = dispatch(idx_p, n_real_groups)
        if in_flight is not None:
            consume(in_flight)
        in_flight = cur
        if cfg.debug and b_idx >= 5:
            break
    if in_flight is not None:
        consume(in_flight)

    val_log: Dict[str, Any] = {}
    gathered: Dict[str, Any] = {}
    if eval_score and qa_results:
        scores = evaluate_qa(qa_results, dataset.qid2data, ans2label,
                             cfg.task)
        if "ratios" in scores:
            gathered["ratios"] = {
                k: [get_rounded_percentage(v[1] / max(n_ex, 1)), v[1]]
                for k, v in scores["ratios"].items()}
        for k, v in scores.items():
            if k == "ratios" or "ratio" in k:
                continue
            gathered[k] = get_rounded_percentage(v)
            val_log[f"{tag}/{k}"] = gathered[k]
    TB_LOGGER.log_scalar_dict(val_log)
    LOGGER.info(f"[{tag}] {n_ex} examples in {time.time() - st:.1f}s: "
                f"{gathered}")
    return {"qa_results": qa_results, "scores": gathered}


def step_math(cfg, n_train_groups: int) -> Tuple[int, int, int]:
    """(num_train_steps, valid_steps, save_steps) on one device
    (reference run_video_qa.py:424-435; save_steps counts micro steps)."""
    total_n_examples = n_train_groups * cfg.max_n_example_per_group
    total_train_batch_size = int(cfg.train_batch_size
                                 * cfg.gradient_accumulation_steps
                                 * cfg.max_n_example_per_group)
    num_train_steps = int(math.ceil(
        1.0 * cfg.num_train_epochs * total_n_examples
        / total_train_batch_size))
    valid_steps = max(int(math.ceil(
        1.0 * num_train_steps / cfg.num_valid / cfg.min_valid_steps))
        * cfg.min_valid_steps, 1)
    save_steps = max(int(cfg.save_steps_ratio * num_train_steps
                         * cfg.gradient_accumulation_steps), 1)
    return num_train_steps, valid_steps, save_steps


def _check_ported(cfg) -> None:
    if cfg.task in ("action", "transition"):
        raise NotImplementedError(f"multiple-choice ({cfg.task}) training "
                                  f"{_NOT_PORTED}")
    if int(np.prod(cfg.get("mesh_shape") or [1])) > 1:
        raise NotImplementedError(f"a mesh of more than one device "
                                  f"{_NOT_PORTED}: the port trains on one")
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        raise NotImplementedError(f"multi-process training (M11) "
                                  f"{_NOT_PORTED}")
    if cfg.model.get("pretrained_weights"):
        raise NotImplementedError(f"model.pretrained_weights (the local HF "
                                  f"loader, M7) {_NOT_PORTED}")
    if int(cfg.get("n_workers", 0) or 0) > 0:
        CollatorPool()          # raises: not ported


def start_training(cfg, *, open_store: Callable[[str], Any] = FrameStoreReader
                   ) -> Dict[str, Any]:
    """Train GIT per ``cfg`` with validation on its cadence, then a final
    validation; returns the final scores, the running train loss and the
    global step.  ``open_store`` opens the frame stores (default HDF5;
    see :func:`setup_datasets`)."""
    platform = cfg.get("platform")
    if platform not in (None, "cpu", "gpu", "cuda"):
        raise ValueError(f"platform {platform!r}: the port runs on 'cpu' "
                         f"or the GPU")
    dev = resolve_device("cpu" if platform == "cpu" else "cuda")
    _check_ported(cfg)
    init_gen, host_rng = set_random_seed(cfg.seed)

    if cfg.get("ans2label_path"):
        from sasvqa_torch.utils.basic import load_json
        ans2label = load_json(cfg.ans2label_path)
    else:
        # answer vocab from the train split, k=1000 (run_video_qa.py:205-208)
        ans2label = build_common_answer_dict((cfg.train_datasets[0].txt,),
                                             1000)
    if len(ans2label) > cfg.num_labels:
        LOGGER.warning(
            f"answer vocabulary ({len(ans2label)} entries) exceeds the "
            f"task's num_labels floor ({cfg.num_labels}); growing it to "
            f"{len(ans2label)}")
        cfg.num_labels = len(ans2label)

    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    family, model = build_model(cfg, dtype=dtype, device=dev,
                                generator=init_gen)
    if family != "git":
        raise NotImplementedError(f"the {family} family's task loop "
                                  f"{_NOT_PORTED}")
    tokenizer = build_tokenizer(cfg, family)
    train_ds, val_ds, test_ds = setup_datasets(cfg, ans2label,
                                               open_store=open_store)

    cfg.num_train_steps, cfg.valid_steps, save_steps = step_math(
        cfg, len(train_ds))

    collator = make_collator(family, tokenizer, cfg)
    # the JAX package collates one probe group for its init shapes; the
    # draw is kept so that both packages' host streams stay in step
    collator([train_ds.get_group(0)], rng=host_rng)
    state = train_steps.create_train_state(
        model, cfg, total_steps=cfg.num_train_steps, device=dev)

    output_dir = cfg.get("output_dir") or "output/run"
    os.makedirs(output_dir, exist_ok=True)
    save_training_meta(output_dir, cfg)
    TB_LOGGER.create(os.path.join(output_dir, "log"))
    log_file = add_log_to_file(os.path.join(output_dir, "log", "log.txt"))
    previous = {}   # the signal handlers this run replaces
    try:
        return _run(cfg, model, state, tokenizer, ans2label, collator,
                    host_rng, (train_ds, val_ds, test_ds), save_steps,
                    output_dir, dev, previous)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        LOGGER.removeHandler(log_file)
        log_file.close()


def _run(cfg, model, state, tokenizer, ans2label, collator, host_rng,
         datasets, save_steps, output_dir, dev, previous) -> Dict[str, Any]:
    """start_training once its log file is open: restore, build the
    steps, validate and train.  Signal handlers it replaces are recorded
    in ``previous`` for the caller to put back."""
    train_ds, val_ds, test_ds = datasets
    saver = ModelSaver(os.path.join(output_dir, "ckpt"))
    restorer = TrainingRestorer(output_dir, save_steps=save_steps)
    state = restorer.restore_into(state)

    # --do_inference evaluates a trained eval snapshot: ckpt/model_step_{N}
    # (or the latest) into the model
    if cfg.do_inference:
        step_req = int(cfg.get("inference_model_step", -1) or -1)
        target = step_req if step_req > 0 else saver.latest_step()
        if target is None:
            LOGGER.warning("inference mode without a saved snapshot: "
                           "evaluating fresh params")
        else:
            LOGGER.info(f"inference: restoring eval snapshot "
                        f"model_step_{target} from {saver.dir}")
            model.load_state_dict(saver.restore(int(target)), strict=True)

    accum = int(cfg.gradient_accumulation_steps)
    use_scan = accum > 1 and bool(cfg.get("scan_accum", 1))
    gmean = bool(cfg.get("accum_grad_mean", 1))
    train_step = (train_steps.make_scan_train_step(accum, "git",
                                                   grad_mean=gmean,
                                                   device=dev)
                  if use_scan else train_steps.make_git_train_step(dev))
    eval_step = train_steps.make_git_eval_step(
        model, max_text_len=cfg.get("gen_max_text_len", 50),
        max_new_tokens=cfg.get("gen_max_new_tokens"), device=dev)
    eval_collator = GITCollator(
        tokenizer, max_txt_len=cfg.max_txt_len,
        max_seq_len=cfg.get("max_seq_len", cfg.max_txt_len + 12),
        task_type=cfg.task, nframe=cfg.nframe, samp_policy=cfg.samp_policy,
        add_ans=False, pixel_dtype=pixel_dtype_for(cfg))

    LOGGER.info(f"***** training: {cfg.num_train_steps} steps, validate "
                f"every {cfg.valid_steps}, on {dev} *****")

    def run_validation(tag_prefix=""):
        if cfg.do_inference:
            # --inference_split picks the one split inference evaluates
            # ('val' has ground truth; 'test*' is predicted, not scored)
            split = str(cfg.get("inference_split", "val"))
            ds = val_ds if split == "val" else test_ds
            res = validate(ds, eval_collator, cfg, tokenizer, ans2label,
                           eval_step, eval_score=not split.startswith("test"),
                           tag=f"{tag_prefix}{split}")
            save_json([{k: v for k, v in r.items() if k != "data"}
                       for r in res["qa_results"]],
                      os.path.join(output_dir, f"qa_results_{split}.json"))
            empty = {"qa_results": [], "scores": {}}
            return (res, empty) if split == "val" else (empty, res)
        res_v = validate(val_ds, eval_collator, cfg, tokenizer, ans2label,
                         eval_step, tag=f"{tag_prefix}valid")
        res_t = validate(test_ds, eval_collator, cfg, tokenizer, ans2label,
                         eval_step, tag=f"{tag_prefix}test")
        return res_v, res_t

    if cfg.get("zero_eval"):
        run_validation("zero_")

    # preemption: on SIGTERM/SIGINT finish the current step, save the
    # restore checkpoint at the accumulation boundary, then return
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        LOGGER.warning(f"signal {signum}: checkpointing for preemption")
        preempted["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread
            pass
    return _train_loop(cfg, state, train_step, train_ds, collator, host_rng,
                       restorer, saver, run_validation, preempted,
                       output_dir, accum, use_scan, dev)


def _train_loop(cfg, state, train_step, train_ds, collator, host_rng,
                restorer, saver, run_validation, preempted, output_dir,
                accum, use_scan, dev) -> Dict[str, Any]:
    running_loss = RunningMeter("train_loss")
    dropout_seed = train_steps.fold_in(cfg.seed, 1)
    start_micro = int(state.step)
    global_step = start_micro // accum
    last_saved_step = -1
    last_scores: Dict[str, Any] = {}
    micro = 0
    debug_cap = 3
    log_every = 10

    # metrics stay device scalars and flush as one stacked transfer at
    # log/validation boundaries: no host sync per step
    pending: List = []

    def flush_metrics():
        if not pending:
            return
        keys = list(pending[0][1].keys())
        mat = torch.stack([torch.stack([m[k].float() for k in keys])
                           for _, m in pending]).cpu().numpy()
        for (gs, _), row in zip(pending, mat):
            vals = dict(zip(keys, row.tolist()))
            running_loss(vals["loss"])
            TB_LOGGER.global_step = gs
            TB_LOGGER.add_scalar("train/loss", vals["loss"])
            # lr is a host function of the step: no device fetch
            TB_LOGGER.add_scalar("train/lr", train_steps.lr_at(
                cfg, cfg.num_train_steps, gs))
            if "grad_norm" in vals:
                TB_LOGGER.add_scalar("train/grad_norm", vals["grad_norm"])
        pending.clear()

    prefetch = None
    if cfg.num_train_steps > 0:
        # inference-only runs skip the pipeline: the prefetch thread starts
        # staging batches on construction
        source = infinite_batches(train_ds, collator, cfg.train_batch_size,
                                  host_rng)
        if use_scan:
            source = stack_microbatches(source, accum)
        # a K-stacked batch is K times the device bytes: depth 1 still
        # overlaps staging with the (K-micro) step
        depth = 1 if use_scan and accum >= 16 else 2
        prefetch = DevicePrefetcher(source, depth=depth, device=dev)

    # --profile_steps: a torch.profiler trace of a window of steps, from
    # this invocation's second step
    prof_n = int(cfg.get("profile_steps", 0) or 0)
    prof_start = global_step + 2
    prof = {"p": None, "stop_at": 0}

    def prof_stop():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof["p"].stop()
        prof["p"].export_chrome_trace(
            os.path.join(output_dir, "trace", "trace.json"))
        prof["p"] = None

    def prof_tick(global_step):
        if prof_n <= 0:
            return
        if prof["p"] is None and global_step == prof_start:
            os.makedirs(os.path.join(output_dir, "trace"), exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].start()
            prof["stop_at"] = global_step + prof_n
            LOGGER.info(f"profiling steps [{prof_start}, {prof['stop_at']}) "
                        f"-> {output_dir}/trace")
        elif prof["p"] is not None and global_step >= prof["stop_at"]:
            prof_stop()

    t_start = time.time()
    # scan path: one iteration consumes K stacked micros and is always an
    # accumulation boundary; state.step still counts micros
    micros_per_call = accum if use_scan else 1
    try:
        for batch, _host in (prefetch if prefetch is not None else ()):
            state, metrics = train_step(state, batch, dropout_seed)
            micro += micros_per_call
            if micro % accum != 0:
                continue
            global_step += 1
            pending.append((global_step, metrics))
            if (global_step % log_every == 0
                    or global_step % cfg.valid_steps == 0
                    or global_step >= cfg.num_train_steps
                    or (cfg.debug and global_step >= debug_cap)
                    or preempted["flag"]):
                flush_metrics()
            if global_step % log_every == 0:
                LOGGER.info(f"step {global_step}/{cfg.num_train_steps} "
                            f"{running_loss} "
                            f"({(time.time() - t_start):.0f}s)")
            prof_tick(global_step)
            restorer.maybe_save(start_micro + micro, state)
            if global_step % cfg.valid_steps == 0:
                if prof["p"] is not None:
                    LOGGER.info("profiling window truncated at a validation "
                                "boundary")
                    prof_stop()
                # the final step skips the in-loop eval: the final
                # validation after the loop evaluates the same params
                if global_step < cfg.num_train_steps:
                    res_v, _ = run_validation()
                    last_scores = res_v["scores"]
                saver.save(global_step, state.model.state_dict())
                last_saved_step = global_step
            # preemption is honoured only at accumulation boundaries, so a
            # resumed run's micro counter stays aligned with the updates
            if preempted["flag"]:
                if prof["p"] is not None:
                    prof_stop()
                restorer.force_save(start_micro + micro, state)
                LOGGER.info("preemption checkpoint saved; exiting")
                return {"val": last_scores, "test": {},
                        "train_loss": running_loss.val,
                        "global_step": global_step, "preempted": True}
            if global_step >= cfg.num_train_steps:
                break
            if cfg.debug and global_step >= debug_cap:
                break
    finally:
        if prefetch is not None:
            prefetch.close()   # release staged batches before final eval
    flush_metrics()
    if prof["p"] is not None:
        prof_stop()
    # a final eval snapshot whenever this invocation trained and the last
    # step missed a validation boundary; an inference-only run never
    # re-saves its restored params
    if micro > 0 and global_step > 0 and last_saved_step != global_step:
        saver.save(global_step, state.model.state_dict())
    res_v, res_t = run_validation("final_")
    return {"val": res_v["scores"], "test": res_t["scores"],
            "train_loss": running_loss.val, "global_step": global_step}


def main(argv: Optional[List[str]] = None):
    cfg = get_video_qa_args(argv)
    if cfg.do_inference:
        # a standalone validation pass: zero train steps fall straight
        # through to the final validation
        LOGGER.info("inference-only mode")
        cfg.num_train_epochs = 0
        cfg.zero_eval = False
    return start_training(cfg)


if __name__ == "__main__":
    main()
