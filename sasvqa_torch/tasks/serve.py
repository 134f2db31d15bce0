"""Batched online inference (counterpart of sasvqa_tpu/tasks/serve.py).

A micro-batching engine that turns concurrent single (video, question)
requests into fixed-shape batches:

- requests enqueue from any thread via :meth:`QAEngine.submit`, which
  returns a ``concurrent.futures.Future``;
- one dispatcher thread drains up to ``batch_size`` requests (after the
  first arrives it lingers ``linger_ms`` for more);
- the batch goes through the training/eval collator
  (``GITCollator(add_ans=False)`` or ``ClassifierCollator``), short
  batches padded by repeating the last request, so every call has one
  shape;
- GIT decodes greedily and answers with the generated text (label = last
  word via ans2label); the CLIP and BLIP classifiers answer ``label2ans``
  of the argmax label.

Weights come with the model: a seeded init, overlaid by
``presets.load_pretrained_params`` with a local HF checkpoint.

The JSONL CLI serves a file of requests through the engine, each video
decoded through stage A's decode (``tasks/predict.load_frames``):

    python -m sasvqa_torch.tasks.serve --requests reqs.jsonl \
        --out answers.jsonl --model microsoft/git-base-msrvtt-qa \
        --weights ./pretrained/git-base-msrvtt-qa --nframe 6

``--platform cpu`` runs it on the CPU; the default is the GPU.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.core.profiling import Span, begin, end, span
from sasvqa_torch.data.dataset import ClassifierCollator, GITCollator
from sasvqa_torch.tasks.predict import load_frames, load_model
from sasvqa_torch.tasks.run_video_qa import decode_answers
from sasvqa_torch.train.steps import (make_classifier_eval_step,
                                      make_git_eval_step)


class QAEngine:
    """Micro-batching video-QA inference engine.

    model: a built model (presets.build_model, weights loaded) on
    ``device``.  family: 'git', 'clip' or 'blip'.  ans2label: the answer
    vocabulary, required for the classifier, optional for GIT (the
    last-word label).  nframe / samp_policy: the collator's frame
    re-sampling.  The dispatcher thread runs every batch under
    ``torch.inference_mode()`` on that thread's current CUDA stream.
    """

    def __init__(self, model, family: str, tokenizer,
                 ans2label: Optional[Dict[str, int]] = None,
                 nframe: int = 4, samp_policy: str = "uniform",
                 batch_size: int = 8, linger_ms: float = 5.0,
                 max_txt_len: int = 20, max_text_len: int = 50,
                 pixel_dtype: str = "f32", device: DeviceLike = "cuda"):
        if family not in ("git", "clip", "blip"):
            raise ValueError(f"unknown model family {family!r}")
        if family != "git" and not ans2label:
            raise ValueError("classifier serving needs an ans2label "
                             "answer vocabulary")
        self.device = resolve_device(device)
        self.family = family
        self.tokenizer = tokenizer
        self.ans2label = ans2label or {}
        self.label2ans = {v: k for k, v in self.ans2label.items()}
        self.batch_size = int(batch_size)
        self.linger_s = float(linger_ms) / 1e3
        if family == "git":
            self._collator = GITCollator(
                tokenizer, max_txt_len=max_txt_len, task_type="msvd_qa",
                nframe=nframe, samp_policy=samp_policy, add_ans=False,
                pixel_dtype=pixel_dtype)
            self._eval_step = make_git_eval_step(
                model, max_text_len=max_text_len, device=self.device)
        else:
            self._collator = ClassifierCollator(
                tokenizer, max_txt_len=max_txt_len, task_type="msvd_qa",
                nframe=nframe, samp_policy=samp_policy,
                pixel_dtype=pixel_dtype)
            self._eval_step = make_classifier_eval_step(model,
                                                        device=self.device)

        self.stats = {"requests": 0, "batches": 0, "batch_rows": 0}
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        # submit()/close() handshake: without it a request that passes the
        # _closed check while close() runs would sit behind the shutdown
        # sentinel with a future that never resolves
        self._lock = threading.Lock()
        # co-batched requests share one collator pass whose frame indices
        # and H/W come from the batch's first item, so the engine pins
        # (K, H, W, 3) to the first submitted shape
        self._frame_shape: Optional[tuple] = None
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="qa-engine")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, frames: np.ndarray, question: str) -> Future:
        """frames: (K, H, W, 3) normalized floats (frame-store layout).
        All requests to one engine share one (K, H, W, 3) shape; the
        first submit pins it.  Returns a Future resolving to
        {"answer": str, "label": int}."""
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be (K, H, W, 3), "
                             f"got {frames.shape}")
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._frame_shape is None:
                self._frame_shape = frames.shape
            elif frames.shape != self._frame_shape:
                raise ValueError(
                    f"frames shape {frames.shape} does not match this "
                    f"engine's pinned shape {self._frame_shape}; requests "
                    "in one engine must share (stored K, H, W, 3)")
            fut: Future = Future()
            self._queue.put((frames, str(question), fut,
                             begin("engine.queue")))
        return fut

    def answer(self, frames: np.ndarray, question: str,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(frames, question).result(timeout=timeout)

    def close(self):
        """Drain outstanding requests, then stop the dispatcher."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _drain_batch(self, batch: Optional[Span] = None
                     ) -> Optional[List[tuple]]:
        """Block for one request, then linger for more (up to
        batch_size).  None = shutdown sentinel seen.  Each request's
        queue span ends as it is taken, with the key of the ``batch``
        span that runs it."""
        first = self._queue.get()
        if first is None:
            return None
        batch_key = None if batch is None else batch.key
        end(first[3], batch=batch_key)
        reqs = [first[:3]]
        deadline = time.monotonic() + self.linger_s
        while len(reqs) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                # keep shutting down after this batch completes
                self._queue.put(None)
                break
            end(nxt[3], batch=batch_key)
            reqs.append(nxt[:3])
        return reqs

    def _dispatch_loop(self):
        # grad mode is thread-local: the caller's no_grad does not reach
        # this thread, so it enters inference mode itself
        with torch.inference_mode():
            while True:
                with span("engine.batch") as batch:
                    with span("engine.drain"):
                        reqs = self._drain_batch(batch)
                    if reqs is None:
                        self._fail_stragglers()
                        return
                    try:
                        results = self._run_batch(reqs)
                        # set_result runs the futures' done-callbacks
                        with span("engine.respond"):
                            for (_, _, fut), res in zip(reqs, results):
                                fut.set_result(res)
                    except Exception as e:  # resolve futures, keep serving
                        LOGGER.exception("serving batch failed")
                        for _, _, fut in reqs:
                            if not fut.done():
                                fut.set_exception(e)

    def _fail_stragglers(self):
        """Requests still queued after the shutdown sentinel can never
        run: fail their futures instead of leaving callers blocked."""
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                return
            if leftover is not None:
                leftover[2].set_exception(
                    RuntimeError("engine closed before this request was "
                                 "dispatched"))

    def _run_batch(self, reqs: List[tuple]) -> List[Dict[str, Any]]:
        n_real = len(reqs)
        with span("engine.collate"):
            items = [{"vid": frames,
                      "examples": [{"q_str": question, "label": None,
                                    "str_label": None, "question_id": i}],
                      "n_examples": 1}
                     for i, (frames, question, _) in enumerate(reqs)]
            # fixed batch shape: repeat the last request into the tail
            items += [items[-1]] * (self.batch_size - n_real)
            batch = self._collator(items, rng=np.random.default_rng(0))
        with span("engine.generate"):
            out = self._eval_step(batch)
        if self.family == "git":
            with span("engine.fetch"):
                generated = out.cpu().numpy()
            with span("engine.respond"):
                preds, strs = decode_answers(
                    self.tokenizer, generated[:n_real], self.ans2label)
                out = [{"answer": s, "label": p}
                       for s, p in zip(strs, preds)]
        else:
            with span("engine.fetch"):
                preds = out[0][:n_real].tolist()
            with span("engine.respond"):
                out = [{"answer": self.label2ans.get(int(p), ""),
                        "label": int(p)} for p in preds]
        self.stats["requests"] += n_real
        self.stats["batches"] += 1
        self.stats["batch_rows"] += self.batch_size
        return out


def serve_requests(engine, requests, decode, out, *, batch_size: int,
                   decode_workers: int = 4) -> None:
    """Bounded decode-ahead request loop.

    A decode thread pool keeps submission bursty enough to fill engine
    batches, while a sliding in-flight window caps memory at O(window)
    decoded clips.  Answers are written to ``out`` in request order."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    window = max(4 * batch_size, 2 * decode_workers)
    with ThreadPoolExecutor(decode_workers) as pool:
        def decode_and_submit(req):
            return engine.submit(decode(req), req["question"])

        pending: deque = deque()

        def drain_one():
            req, dfut = pending.popleft()
            res = dfut.result().result()   # decode future -> answer
            out.write(json.dumps({"question": req["question"],
                                  **res}) + "\n")

        for req in requests:
            pending.append((req, pool.submit(decode_and_submit, req)))
            if len(pending) >= window:
                drain_one()
        while pending:
            drain_one()


def build_argparser():
    p = argparse.ArgumentParser(
        description="batched video-QA serving over JSONL requests")
    p.add_argument("--requests", required=True,
                   help="JSONL file of {'video': path, 'question': str}")
    p.add_argument("--out", required=True, help="JSONL output path")
    p.add_argument("--model", default="microsoft/git-base-msrvtt-qa")
    p.add_argument("--weights", default=None,
                   help="local HF checkpoint dir")
    p.add_argument("--orbax_ckpt", default=None,
                   help="a training run's ckpt/ dir of this package's "
                        "ModelSaver snapshots (the name is the JAX CLI's)")
    p.add_argument("--orbax_step", type=int, default=-1,
                   help="snapshot step to serve; -1 = latest (0 is a "
                        "valid explicit step)")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--ans2label_path", default=None,
                   help="answer vocab JSON (required for classifiers)")
    p.add_argument("--classifier", default="mlp")
    p.add_argument("--num_labels", type=int, default=1000)
    p.add_argument("--nframe", type=int, default=6)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--stored_frames", type=int, default=16,
                   help="frames decoded per video before the collator's "
                        "nframe re-sampling (the stage-A K)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--decode_workers", type=int, default=4,
                   help="decode-ahead threads: enough decode throughput "
                        "to fill engine batches without holding every "
                        "clip in memory at once")
    p.add_argument("--linger_ms", type=float, default=5.0)
    p.add_argument("--pixel_dtype", default="u8",
                   choices=["f32", "bf16", "u8"],
                   help="request->device pixel wire format.  u8 is "
                        "lossless here: the CLI's frames come from uint8 "
                        "decodes (core/pixels.py)")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    family, model, tokenizer = load_model(
        args, args.orbax_step if args.orbax_step >= 0 else None, device)
    ans2label = None
    if args.ans2label_path:
        with open(args.ans2label_path) as f:
            ans2label = json.load(f)
    with open(args.requests) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    LOGGER.info(f"serving {len(requests)} requests "
                f"(batch_size={args.batch_size})")

    def decode(req):
        return load_frames(req["video"], args.stored_frames,
                           args.img_size)[0]

    with QAEngine(model, family, tokenizer, ans2label=ans2label,
                  nframe=args.nframe, batch_size=args.batch_size,
                  linger_ms=args.linger_ms, pixel_dtype=args.pixel_dtype,
                  device=device) as engine, open(args.out, "w") as out:
        serve_requests(engine, requests, decode, out,
                       batch_size=args.batch_size,
                       decode_workers=args.decode_workers)
    LOGGER.info(f"done: {engine.stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
