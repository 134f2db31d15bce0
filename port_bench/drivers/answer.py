"""Answering cells: closed-loop clients on the serving engine.

The model is GIT as the serve CLI loads it (the steps of
``tasks.predict.load_model``: the seeded bf16 model overlaid by the
checkpoint), behind ``tasks.serve.QAEngine`` with the traffic's batch
size, linger and decode budget.  ``clients`` closed-loop clients each
have one (video, question) request out and send the next when its
answer is back; the videos are drawn uniformly and the questions from
the store's generator, from the seed.  The store is laid out once as the
engine takes frames (stored frames, channels last), so a client's
request is a view of it.

After a warm-up of two waves the window opens; clients stop submitting
at ``--seconds`` and the window closes when the last answer is back.
Latency is submit to resolved future, over every request of the window.
With ``--trace 1`` the same traffic runs a few seconds more under the
profiler.

A benchmark-side wrapper keeps the token ids each batch generated (the
engine answers with their text), so that the reference can judge them:
a sample of the window's requests drawn from the seed, the longest
among them, runs through the plain f32 model over its prompt and served
tokens.  At each served position the gap is how far the served token's
reference logit lies below the reference's best.  The number compared,
``token_gap_contested``, is the sum of the gaps over the number of
contested positions: those where the reference's two best logits lie
within the traffic's ``contested_margin`` of each other.  A wrong pick
only happens where the margin is smaller than the logits' error, so the
sum of gaps grows with how many such near-ties a seed's model has; the
count of contested positions, which the reference alone decides, takes
that out, and what remains grows with the size of the error.  Not the
widest gap: a random-weight model's top logits lie close together, which
caps the gap of any wrong pick, so the widest gap of a lower precision
hardly exceeds the program's own.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from port_bench import families, stats, store, trace, weights
from port_bench.drivers.train import (_data_seed, _weight_seed, frame_rows,
                                     setup_data)
from port_bench.reference import common
from port_bench.reference import text as ref_text


class _Clients:
    """Closed-loop clients over pre-drawn requests (``draws``: a row of
    question indices a client).  A client's next request goes out from
    its previous answer's done-callback (on the engine's dispatcher
    thread, right as the answer resolves), so the load needs no thread of
    its own: the process runs the engine's threads and nothing else."""

    def __init__(self, engine, frames_of, questions, draws):
        self.engine = engine
        self.frames_of = frames_of
        self.questions = questions
        self.draws = draws
        self.pos = [0] * len(draws)
        self.done: List[Dict[str, Any]] = []
        self.failed = 0
        self.lock = threading.Lock()
        self.finished = threading.Event()
        self.active = 0
        self.stop_at = 0.0
        self.at_least = 0

    def _submit(self, c: int) -> None:
        q = int(self.draws[c][self.pos[c] % len(self.draws[c])])
        self.pos[c] += 1
        t0 = time.perf_counter()
        fut = self.engine.submit(self.frames_of(q), self.questions[q])
        fut.add_done_callback(lambda f: self._answered(c, q, t0, f))

    def _answered(self, c: int, q: int, t0: float, fut) -> None:
        t1 = time.perf_counter()
        with self.lock:
            if fut.exception() is not None:
                self.failed += 1
            else:
                self.done.append({"q": q, "latency_s": t1 - t0,
                                  "tokens": fut.result()["tokens"]})
        if self.pos[c] < self.at_least or t1 < self.stop_at:
            self._submit(c)
            return
        with self.lock:
            self.active -= 1
            if self.active == 0:
                self.finished.set()

    def run(self, seconds: float, at_least: int = 0) -> float:
        """Every client sends until ``seconds`` from now (and at least
        ``at_least`` requests); the wall until the last answer is back."""
        t0 = time.perf_counter()
        self.stop_at, self.at_least = t0 + seconds, at_least
        self.pos = [0] * len(self.draws)
        self.active = len(self.draws)
        self.finished.clear()
        for c in range(len(self.draws)):
            self._submit(c)
        if not self.finished.wait(timeout=seconds + 600):
            raise RuntimeError("the clients' last answers did not come")
        return time.perf_counter() - t0


def _capture_tokens(engine):
    """Attach each row's generated ids to the engine's results."""
    last = {}
    real_eval, real_run = engine._eval_step, engine._run_batch

    def eval_step(batch):
        last["ids"] = real_eval(batch)
        return last["ids"]

    def run_batch(reqs):
        res = real_run(reqs)
        ids = last["ids"].cpu().numpy()
        for r, row in zip(res, ids):
            r["tokens"] = [int(t) for t in row]
        return res

    engine._eval_step, engine._run_batch = eval_step, run_batch


def served(tokens: List[int], budget: int, pad: int) -> List[int]:
    """The tokens a request was served: up to the decode budget, through
    the first pad (a finished row, or [SEP], which the engine writes as
    pad)."""
    out = []
    for t in tokens[:budget]:
        out.append(t)
        if t == pad:
            break
    return out


def token_gaps(fam, W, c, frames, prompts, served_rows, vocab_map, dev,
               quant: bool = False, block: int = 8) -> List[Dict[str, Any]]:
    """For each request, the reference's logits at every served
    position: (best logit - served token's logit) in f32, the margin
    between the two best, and with ``quant`` the f32 gap of the token
    the float8 reference puts first.  A pad position is judged as the
    better of [PAD] and [SEP]."""
    pad, sep = vocab_map["[PAD]"], vocab_map["[SEP]"]
    ar32, ar8 = common.Arith(False), common.Arith(True)
    out = []
    with torch.no_grad():
        for i in range(0, len(prompts), block):
            rows = list(range(i, min(i + block, len(prompts))))
            lens = [len(prompts[r]) + len(served_rows[r]) for r in rows]
            width = max(lens)
            ids = np.full((len(rows), width), pad, np.int64)
            mask = np.zeros((len(rows), width), np.int64)
            for j, r in enumerate(rows):
                seq = prompts[r] + served_rows[r]
                ids[j, :len(seq)] = seq
                mask[j, :len(seq)] = 1
            pix = torch.from_numpy(np.stack([frames[r] for r in rows])).to(
                dev)
            ids_t = torch.from_numpy(ids).to(dev)
            mask_t = torch.from_numpy(mask).to(dev)
            lg = fam.next_token_logits(W, c, pix, ids_t, mask_t, ar32)
            lg8 = fam.next_token_logits(W, c, pix, ids_t, mask_t, ar8) \
                if quant else None
            for j, r in enumerate(rows):
                p = len(prompts[r])
                for t, tok in enumerate(served_rows[r]):
                    row = lg[j, p - 1 + t]
                    top2 = torch.topk(row, 2).values
                    best = float(top2[0])
                    got = float(torch.maximum(row[pad], row[sep])) \
                        if tok == pad else float(row[tok])
                    rec = {"gap": best - got,
                           "margin": best - float(top2[1])}
                    if lg8 is not None:
                        rec["control_gap"] = best - float(
                            row[int(lg8[j, p - 1 + t].argmax())])
                    out.append(rec)
    return out


def run(cell, seed: int, seconds: float, trace_on: bool,
        device="cuda", t0: Optional[float] = None,
        fault: Optional[str] = None, calibrate=()) -> Dict[str, Any]:
    """One run of an answering cell; the result line's fields.
    ``fault`` ``altered_token`` changes one served token (the harness's
    tests); ``calibrate`` ``control_fp8`` also reads the float8
    reference's gap."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    from sasvqa_torch.core.config import ConfigDict
    from sasvqa_torch.models.presets import (build_model,
                                             load_pretrained_params)
    from sasvqa_torch.ops import _build
    from sasvqa_torch.tasks.run_video_qa import build_tokenizer
    from sasvqa_torch.tasks.serve import QAEngine

    c, traffic = cell.config, cell.traffic
    fam = families.load(c["family"])
    eng = traffic["engine"]
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    engine = None
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
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # the serve CLI's load (tasks.predict.load_model) of the model the
        # configuration file states, its vocabulary the one written
        cfg = ConfigDict({"model": {"pretrained_model": c["program_model"],
                                    "vocab_size": c["vocab_size"]},
                          "img_size": c["vision_config"]["image_size"],
                          "tokenizer_dir": tok_dir})
        family, model = build_model(cfg, dtype=torch.bfloat16, device=dev)
        tokenizer = build_tokenizer(cfg, family)
        load_pretrained_params(family, model, ckpt_dir)
        engine = QAEngine(
            model, family, tokenizer, nframe=eng["nframe"],
            samp_policy=eng["samp_policy"], batch_size=eng["batch_size"],
            linger_ms=eng["linger_ms"], max_txt_len=eng["max_txt_len"],
            max_text_len=eng["max_text_len"],
            pixel_dtype=eng["pixel_dtype"], device=dev)
        _capture_tokens(engine)
        marks["engine"] = time.perf_counter() - t0
        if fault == "altered_token":
            real_run = engine._run_batch

            def altered(reqs):
                res = real_run(reqs)
                res[0]["tokens"][0] = (res[0]["tokens"][0] + 1) % c[
                    "vocab_size"]
                return res
            engine._run_batch = altered

        annos = data["annotations"][traffic["split"]]
        questions = [a["question"] for a in annos]
        rows = np.array([store.video_row(a) for a in annos])
        k = data["frames"].shape[1]
        img = c["vision_config"]["image_size"]
        # every video laid out once as the engine takes it (K, H, W, 3):
        # a client's request is then a view, and the clients do no host
        # work but waiting
        frames_all = np.ascontiguousarray(data.pop("frames").reshape(
            -1, k, 3, img, img).transpose(0, 1, 3, 4, 2))

        def frames_of(q: int) -> np.ndarray:
            return frames_all[rows[q]]

        rng = np.random.default_rng(_data_seed(seed) + 1)
        n_clients = int(traffic["clients"])
        draws = rng.integers(0, len(annos), size=(n_clients, 4096))
        warm = _Clients(engine, frames_of, questions,
                        rng.integers(0, len(annos), size=(n_clients, 4096)))
        warm.run(0.0, at_least=2)      # two waves
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = dict(engine.stats)
        t_open = time.perf_counter()
        clients = _Clients(engine, frames_of, questions, draws)
        window_s = clients.run(seconds)
        after = dict(engine.stats)
        setup_s = t_open - t0
        profiled = None
        if trace_on:
            extra = _Clients(engine, frames_of, questions, draws[:, ::-1])
            profiled = {"prof": trace.profile(
                lambda: extra.run(float(traffic["trace_seconds"])))}
            profiled["summary"] = trace.summary(profiled.pop("prof"))
            profiled["answers"] = len(extra.done)
        engine.close()
        engine = None
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        del model
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        done = clients.done
        lat = [d["latency_s"] for d in done]
        budget = eng["max_text_len"] - eng["max_txt_len"]
        vocab_map = ref_text.read_vocab(os.path.join(tok_dir, "vocab.txt"))
        pad = vocab_map["[PAD]"]
        pick = np.random.default_rng(_data_seed(seed) + 2).choice(
            len(done), size=min(int(traffic["judged_requests"]), len(done)),
            replace=False).tolist()
        longest = max(range(len(done)), key=lambda i: len(
            served(done[i]["tokens"], budget, pad)))
        if longest not in pick:
            pick[0] = longest
        judged = [done[i] for i in pick]
        prompts = [fam.prompt(vocab_map, questions[d["q"]])
                   for d in judged]
        served_rows = [served(d["tokens"], budget, pad) for d in judged]
        frames = [np.ascontiguousarray(frames_all[rows[d["q"]]][
            frame_rows((eng["samp_policy"], int(eng["nframe"])), None, k)]
            .transpose(0, 3, 1, 2)) for d in judged]
        t_ref = time.perf_counter()
        W = weights.load(ckpt_dir, dev)
        with common.no_tf32():
            gaps = token_gaps(fam, W, c, frames, prompts, served_rows, vocab_map,
                              dev, quant="control_fp8" in calibrate)
        failed = {"failed": float(clients.failed)}
        margins = [g["margin"] for g in gaps]
        delta = float(traffic["contested_margin"])
        checks = dict(gap_stats([g["gap"] for g in gaps], margins, delta),
                      **failed)
        controls = {}
        if "control_fp8" in calibrate:
            controls["control_fp8"] = dict(gap_stats(
                [g["control_gap"] for g in gaps], margins, delta), **failed)
        record = {"kind": "answer", "config": c, "window_s": window_s,
                  "reference_s": time.perf_counter() - t_ref,
                  "requests": after["requests"] - before["requests"],
                  "batch_rows": after["batch_rows"] - before["batch_rows"],
                  "profiled": profiled,
                  "judged_tokens": len(gaps),
                  "setup_marks_s": dict(marks, window=setup_s)}
        e2e = {"answer_qa_per_s": len(done) / window_s,
               "answer_ms_p95": 1e3 * stats.percentile(lat, 95),
               "setup_s": setup_s, "peak_mem_gb": peak / 1e9}
        return {"record": record, "e2e": e2e, "checks": checks,
                "controls": controls,
                "attempted": len(done) + clients.failed,
                "failed": clients.failed, "peak_bytes": peak,
                "launches": launches}
    finally:
        if engine is not None:
            engine.close()
        shutil.rmtree(tmp, ignore_errors=True)


CALIBRATION_MARGINS = (0.025, 0.05, 0.1, 0.2)


def contested_gap(gaps: List[float], margins: List[float],
                  delta: float) -> float:
    """The sum of the gaps over the count of positions whose reference
    margin is under ``delta`` (at least one)."""
    contested = sum(1 for m in margins if m < delta)
    return float(np.sum(gaps)) / max(contested, 1)


def gap_stats(gaps: List[float], margins: List[float],
              delta: float) -> Dict[str, float]:
    """``token_gap_contested``, the number compared, at the traffic's
    margin; beside it the mean and widest gap, the share of tokens that
    are not the reference's first, and the contested gap at the margins
    the limit is calibrated over."""
    out = {"token_gap_contested": contested_gap(gaps, margins, delta),
           "token_gap_mean": float(np.mean(gaps)),
           "token_gap_max": float(np.max(gaps)),
           "not_first_share": float(np.mean([g > 0 for g in gaps])),
           "contested_share": float(np.mean([m < delta for m in margins]))}
    for d in CALIBRATION_MARGINS:
        out[f"token_gap_contested_{d:g}"] = contested_gap(gaps, margins, d)
    return out
