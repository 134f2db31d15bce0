"""Training cells: the task loop users run, from the outside.

The run drives ``sasvqa_torch.tasks.run_video_qa.main`` on the traffic's
shipped task config, edited only for data: the seeded store (in host
memory) and annotations, the seeded checkpoint as
``model.pretrained_weights``, the vocabulary as ``tokenizer_dir``, the
run seed, ``zero_eval: 0`` and an ``output_dir`` under ``TMPDIR``; the
model, vocabulary size and image size are the configuration file's
(the shipped ones in every cell of ``BENCHMARK.json``).  What is the
model family's own (its checkpoint, reference loss, leaf names and
FLOPs) comes from ``port_bench/families/<family>.py``.

Two benchmark-side wrappers observe the loop:

- the step factory the loop calls (``make_scan_train_step``) is wrapped,
  so that every update is stamped: the first ``follow_updates`` are
  set-up (the reference follows them: the run seed, the micro step and
  the questions of each micro are kept, with the parameters before the
  first update, the optimizer's first moments after it and the
  parameters after the last); the window opens after them, behind a
  synchronize, and closes with a synchronize after the first update
  that ends at or after ``--seconds``; with ``--trace 1`` one more
  update runs under the profiler; then the wrapper raises, which ends
  the loop without a restore save;
- the loop's ``DevicePrefetcher`` is a subclass that times how long the
  loop's thread waits in ``__next__`` and keeps each batch's question
  ids.

After the window the program is freed and the plain reference follows
the set-up updates from the checkpoint file, on the same questions,
dropout draws and optimizer settings.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from port_bench import families, store, trace, vocab, weights
from port_bench.reference import common
from port_bench.reference import text as ref_text


class WindowClosed(Exception):
    pass


def _data_seed(seed: int) -> int:
    return common.fold_in(seed, 2)


def _weight_seed(seed: int) -> int:
    return common.fold_in(seed, 1)


def task_seed(seed: int) -> int:
    """The task config's ``seed`` (numpy's global seeding takes 32
    bits)."""
    return int(seed) % (2 ** 31)


class Recorder:
    """The stamps and copies of one run (see the module docstring)."""

    def __init__(self, follow: int, seconds: float, trace_on: bool,
                 device: torch.device, beta1: float):
        self.follow_n = follow
        self.seconds = seconds
        self.trace_on = trace_on
        self.dev = device
        self.beta1 = beta1
        self.calls = 0
        self.follow: List[Dict[str, Any]] = []
        self.losses: List[torch.Tensor] = []
        self.p0 = self.g1 = self.pk = None
        self.names: List[str] = []
        self.t_open = self.t_close = None
        self.window: List[Dict[str, Any]] = []
        self.wait_at_open = 0
        self.waits: List[float] = []
        self.profiled: Optional[Dict[str, Any]] = None
        self.prefetcher = None

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _params(self, state) -> Dict[str, torch.Tensor]:
        return {n: p.detach().float().cpu().clone()
                for n, p in state.model.named_parameters()}

    def _follow(self, step, state, batch, seed, qids):
        i = len(self.follow)
        if i == 0:
            self.names = [n for n, _ in state.model.named_parameters()]
            self.p0 = self._params(state)
        self.follow.append({"qids": [list(map(int, q)) for q in qids],
                            "step0": int(state.step)})
        state, metrics = step(state, batch, seed)
        self.losses.append(metrics["loss"].detach().float())
        if i == 0:      # the first moments are (1 - beta1) g
            self.g1 = {n: (m.float() / (1.0 - self.beta1)).cpu()
                       for n, m in zip(self.names, state.optimizer.mu)}
        if i == self.follow_n - 1:
            self.pk = self._params(state)
        return state, metrics

    def wrap(self, step):
        def run(state, batch, seed):
            i = self.calls
            self.calls += 1
            qids = self.prefetcher.last_host["question_ids"]
            lens = batch["text_attention_mask"].sum(-1)
            shape = tuple(batch["visual_inputs"].shape[:3]) + (
                int(batch["text_attention_mask"].shape[-1]),)
            if i < self.follow_n:
                state, metrics = self._follow(step, state, batch, seed, qids)
                if i == self.follow_n - 1:
                    self._sync()
                    self.t_open = time.perf_counter()
                    self.wait_at_open = len(self.prefetcher.waits)
                return state, metrics
            if self.t_close is None:
                state, metrics = step(state, batch, seed)
                self.window.append({"lens": lens, "shape": shape,
                                    "qa": shape[0] * shape[1],
                                    "end": time.perf_counter()})
                if time.perf_counter() - self.t_open >= self.seconds:
                    self._sync()
                    self.t_close = time.perf_counter()
                    self.waits = self.prefetcher.waits[
                        self.wait_at_open:self.wait_at_open
                        + len(self.window)]
                    if not self.trace_on:
                        raise WindowClosed
                return state, metrics
            out = []
            prof = trace.profile(lambda: out.append(step(state, batch,
                                                         seed)))
            self.profiled = {"prof": prof, "lens": lens, "shape": shape}
            raise WindowClosed
        return run


def _prefetcher_class(base, recorder: Recorder):
    class TimedPrefetcher(base):
        """The loop's prefetcher, timing the consumer's waits."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.waits: List[float] = []
            self.last_host = None
            recorder.prefetcher = self

        def __next__(self):
            t0 = time.perf_counter()
            arrays, host = super().__next__()
            self.waits.append(time.perf_counter() - t0)
            self.last_host = host
            return arrays, host

    return TimedPrefetcher


def build_task_config(cell_cfg, traffic, seed: int, tmp: str,
                      paths: Dict[str, str], tok_dir: str, ckpt_dir: str,
                      device: torch.device) -> Dict[str, Any]:
    cfg = json.loads(json.dumps(traffic["task_config"]))
    name = traffic["dataset"]
    cfg.update({
        "train_datasets": [{"name": name, "txt": paths["train"],
                            "img": paths["store"]}],
        "val_datasets": [{"name": name, "txt": paths["val"],
                          "img": paths["store"]}],
        "inference_txt_db": paths["test"],
        "inference_img_db": paths["store"],
        "vid_mapping": paths["vidmapping"],
        "tokenizer_dir": tok_dir,
        "output_dir": os.path.join(tmp, "run"),
        "zero_eval": 0,
        "seed": task_seed(seed),
    })
    # the model the configuration file states, its vocabulary the one
    # written to tokenizer_dir
    cfg["model"] = dict(cfg["model"], pretrained_weights=ckpt_dir,
                        pretrained_model=cell_cfg["program_model"],
                        vocab_size=cell_cfg["vocab_size"])
    cfg["img_size"] = cell_cfg["vision_config"]["image_size"]
    if device.type == "cpu":
        cfg["platform"] = "cpu"
    return cfg


def setup_data(cell_cfg, traffic, seed: int, tmp: str):
    s = traffic["store"]
    data = store.make(s["num_videos"], s["k"], cell_cfg["vision_config"][
        "image_size"], s["questions"], _data_seed(seed))
    if traffic.get("annotation_format") == "msrvtt":
        data = store.msrvtt_format(data)
    paths = store.write_annotations(data, os.path.join(tmp, "data"))
    paths["store"] = os.path.join(tmp, "data", "frames.h5")
    tok_dir = vocab.write(os.path.join(tmp, "tokenizer"),
                          cell_cfg["vocab_size"], store.words())
    return data, paths, tok_dir


def _follow_reference(fam, cell_cfg, cfg, data, rec: Recorder,
                      tok_dir: str, ckpt_dir: str, dev: torch.device,
                      quant: bool = False, fault: Optional[str] = None
                      ) -> Dict[str, Any]:
    """The reference over the recorded set-up updates: per-update losses,
    the first update's clipped gradient and the parameters after the
    last, by checkpoint key."""
    W = weights.load(ckpt_dir, dev)
    params = {k: v.requires_grad_(True) for k, v in W.items()
              if fam.trainable(k)}
    opt_name = str(cfg.get("optim", "adamw")).lower()
    betas = tuple(float(b) for b in cfg["betas"])
    opt = common.AdamW(params, float(cfg["learning_rate"]), betas,
                        float(cfg["weight_decay"]) if opt_name == "adamw"
                        else 0.0, float(cfg.get("grad_norm", -1) or -1))
    vocab_map = ref_text.read_vocab(os.path.join(tok_dir, "vocab.txt"))
    annos = data["annotations"]["train"]
    frames = data["frames"]
    k = frames.shape[1]
    policy = (cfg["samp_policy"], int(cfg["nframe"]))
    img = cell_cfg["vision_config"]["image_size"]
    text_len = int(cfg.get("max_seq_len", cfg.get("max_txt_len", 20) + 12))
    drop_seed = common.fold_in(int(cfg["seed"]), 1)
    ar = common.Arith(quant)
    losses, g1 = [], None
    for upd in rec.follow:
        sums = {kk: torch.zeros_like(p) for kk, p in params.items()}
        micro_losses = []
        for i, qids in enumerate(upd["qids"]):
            if fault == "half_batch":
                qids = qids[:max(len(qids) // 2, 1)]
            rows = [annos[q] for q in qids]
            vids = [store.video_row(a) for a in rows]
            pix = np.stack([frames[v][frame_rows(policy, a, k)]
                            for v, a in zip(vids, rows)])
            pix = torch.from_numpy(pix).to(dev).reshape(
                len(rows), -1, 3, img, img)
            gen = torch.Generator(device=dev).manual_seed(
                common.fold_in(drop_seed, upd["step0"] + i))
            loss = fam.micro_loss(params, cell_cfg, rows, pix, vocab_map,
                                  text_len, gen, ar)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            with torch.no_grad():
                for (kk, s), g in zip(sums.items(), grads):
                    if g is not None:
                        s.add_(g)
            micro_losses.append(float(loss.detach()))
        n = len(upd["qids"])
        mean = {kk: s / n for kk, s in sums.items()}
        clipped = opt.clip(mean)
        if g1 is None:
            g1 = {kk: v.detach().clone() for kk, v in clipped.items()}
        opt.step(clipped)
        losses.append(float(np.mean(micro_losses)))
    return {"losses": losses, "g1": g1,
            "params": {kk: p.detach() for kk, p in params.items()},
            "p0": {kk: v for kk, v in weights.load(ckpt_dir, dev).items()
                   if fam.trainable(kk)}}


def frame_rows(policy, anno, k: int) -> List[int]:
    """The stored frames a question reads, by the sampling policy's
    definition: ``uniform`` every ``nframe``-th frame from 0, ``single``
    the middle frame, ``question-caption`` the first ``nframe`` of the
    question's ``sampled_inds``."""
    policy, n = policy
    if policy == "uniform":
        return list(range(0, k, n))
    if policy == "single":
        return [k // 2]
    if policy == "question-caption":
        return list(anno["sampled_inds"][:n])
    raise ValueError(f"no reference for sampling policy {policy!r}")


def program_norms(fam, prog: Dict[str, Any]) -> Dict[str, Any]:
    """The program's side of the comparison by checkpoint key: each
    update's loss, the first update's gradient norms (its optimizer's
    first moments over 1 - beta1) and the parameters' change norms."""
    names = prog["names"]
    return {"losses": prog["losses"],
            "g": fam.leaf_norms(prog["g1"], names),
            "d": fam.leaf_norms(
                {n: prog["pk"][n] - prog["p0"][n] for n in names}, names)}


def reference_norms(ref: Dict[str, Any]) -> Dict[str, Any]:
    return {"losses": ref["losses"],
            "g": {k: float(v.double().norm()) for k, v in ref["g1"].items()},
            "d": {k: float((ref["params"][k] - ref["p0"][k]).double().norm())
                  for k in ref["params"]}}


def gaps(a: Dict[str, Any], r: Dict[str, Any]) -> Dict[str, float]:
    """The numbers ``correct`` compares, of side ``a`` against the
    reference ``r``:

    - ``loss_gap``: the largest relative gap of an update's mean loss;
    - ``grad_gap``: over the checkpoint's leaves, the largest gap between
      the norms of the first update's clipped gradient, over the larger
      of the reference leaf's norm and the median leaf's;
    - ``change_gap``: the same for the parameters' change over the
      updates followed, leaving out leaves whose reference gradient norm
      is under a thousandth of the median leaf's (Adam moves those by
      round-off alone)."""
    loss = max(abs(p - q) / abs(q) for p, q in zip(a["losses"],
                                                   r["losses"]))
    g_a, g_r, d_a, d_r = a["g"], r["g"], a["d"], r["d"]
    if set(g_a) != set(g_r):
        raise RuntimeError(f"leaves differ: {sorted(set(g_a) ^ set(g_r))}")
    med_g = float(np.median(list(g_r.values())))
    grad = max(abs(g_a[k] - g_r[k]) / max(g_r[k], med_g) for k in g_r)
    moved = [k for k in g_r if g_r[k] >= 1e-3 * med_g]
    med_d = float(np.median([d_r[k] for k in moved]))
    change = max(abs(d_a[k] - d_r[k]) / max(d_r[k], med_d) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def run(cell, seed: int, seconds: float, trace_on: bool,
        device="cuda", t0: Optional[float] = None,
        fault: Optional[str] = None, calibrate=()) -> Dict[str, Any]:
    """One run of a training cell; the result line's fields.  ``fault``
    breaks the timed path (the harness's tests); ``calibrate`` names
    sides to read against the reference besides the program:
    ``control_fp8`` (the reference on float8 operands) and
    ``half_batch`` (the reference on half of every micro's rows)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    from sasvqa_torch.data.frame_store import MemoryFrameStores
    from sasvqa_torch.ops import _build
    from sasvqa_torch.tasks import run_video_qa
    from sasvqa_torch.train import steps as train_steps

    c, traffic = cell.config, cell.traffic
    fam = families.load(c["family"])
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        marks = {"start": time.perf_counter() - t0}
        data, paths, tok_dir = setup_data(c, traffic, seed, tmp)
        marks["data"] = time.perf_counter() - t0
        sd = weights.seeded_state_dict(fam.checkpoint_shapes(c),
                                       _weight_seed(seed), dev,
                                       fam.is_layer_norm_weight)
        ckpt_dir = weights.write(os.path.join(tmp, "ckpt"), sd)
        del sd
        marks["checkpoint"] = time.perf_counter() - t0
        cfg = build_task_config(c, traffic, seed, tmp, paths, tok_dir,
                                ckpt_dir, dev)
        cfg_path = os.path.join(tmp, "task.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        stores = MemoryFrameStores()
        stores.rows[paths["store"]] = data["frames"]
        rec = Recorder(int(traffic["follow_updates"]), seconds, trace_on,
                       dev, float(cfg["betas"][0]))
        real_factory = train_steps.make_scan_train_step
        real_prefetcher = run_video_qa.DevicePrefetcher

        def factory(*a, **kw):
            marks["loop"] = time.perf_counter() - t0
            step = real_factory(*a, **kw)
            return rec.wrap(step if fault is None else _faulty(step, fault))

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        train_steps.make_scan_train_step = factory
        run_video_qa.DevicePrefetcher = _prefetcher_class(real_prefetcher,
                                                          rec)
        try:
            run_video_qa.main(["--task", traffic["task"], "--config",
                               cfg_path], open_store=stores.open_store)
        except WindowClosed:
            pass
        finally:
            train_steps.make_scan_train_step = real_factory
            run_video_qa.DevicePrefetcher = real_prefetcher
        if rec.t_close is None:
            raise RuntimeError(f"the loop ended after {rec.calls} updates, "
                               f"before the window closed")
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        setup_s = rec.t_open - t0
        window_s = rec.t_close - rec.t_open
        qa = sum(u["qa"] for u in rec.window)
        prog = {"losses": [float(x) for x in rec.losses], "g1": rec.g1,
                "p0": rec.p0, "pk": rec.pk, "names": rec.names}
        lens = [u["lens"].cpu().numpy() for u in rec.window]
        shapes = [u["shape"] for u in rec.window]
        profiled = rec.profiled
        if profiled is not None:
            profiled["lens"] = profiled["lens"].cpu().numpy()
        waits = list(rec.waits)
        rec.prefetcher = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        with common.no_tf32():
            ref = reference_norms(_follow_reference(
                fam, c, cfg, data, rec, tok_dir, ckpt_dir, dev))
            ref_s = time.perf_counter() - t_ref
            checks = gaps(program_norms(fam, prog), ref)
            controls = {}
            for what in calibrate:
                side = reference_norms(_follow_reference(
                    fam, c, cfg, data, rec, tok_dir, ckpt_dir, dev,
                    quant=what == "control_fp8",
                    fault=what if what != "control_fp8" else None))
                controls[what] = gaps(side, ref)
        record = {
            "kind": "train", "config": c, "window_s": window_s,
            "reference_s": ref_s,
            "update_ends_s": [u["end"] - rec.t_open for u in rec.window],
            "setup_marks_s": dict(marks, window=setup_s),
            "updates": len(rec.window), "qa": qa, "input_wait_s": waits,
            "flops": sum(fam.update_flops(c, s, l)
                         for s, l in zip(shapes, lens)),
            "profiled": None if profiled is None else fam.profiled(
                c, profiled),
        }
        e2e = {"train_qa_per_s": qa / window_s, "setup_s": setup_s,
               "peak_mem_gb": peak / 1e9}
        return {"record": record, "e2e": e2e, "checks": checks,
                "controls": controls,
                "attempted": qa, "failed": 0, "peak_bytes": peak,
                "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _faulty(step, fault: str):
    """The timed path broken underneath, for the harness's own tests:
    ``frozen_state`` returns the state unchanged, ``half_batch`` trains
    on the first half of every micro's rows."""
    if fault == "frozen_state":
        def frozen(state, batch, seed):
            dev = batch["text_input_ids"].device
            return state, {"loss": torch.zeros((), device=dev)}
        return frozen
    if fault == "half_batch":
        def run(state, batch, seed):
            half = {k: (v[:, :max(v.shape[1] // 2, 1)]
                        if v is not None else v) for k, v in batch.items()}
            return step(state, half, seed)
        return run
    raise ValueError(fault)
