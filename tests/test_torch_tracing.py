"""The port's spans (``sasvqa_torch.core.profiling``) on the CPU: recorded
only under a profiler, nested by thread, across threads by handle, one
session at a time, on the profiler's clock; and the spans the train
step, the input path, ``greedy_generate``, ``QAEngine`` and the task
loop's ``--profile_steps`` trace put where the work happens."""

import json
import os
import statistics
import threading
import time

import numpy as np
import pytest
import torch

from sasvqa_torch.core.profiling import begin, end, span, spans

IMG, K_STORED, NFRAME = 32, 4, 2
TINY_GIT = {"model": {"pretrained_model": "tiny-git", "vocab_size": 512},
            "img_size": IMG}


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def _events(prof, name):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_nothing_is_recorded_without_a_profiler():
    with _profiler():
        with span("before"):
            pass
    kept = spans()
    assert [s.name for s in kept] == ["before"]
    with span("off", micro=3) as got:
        assert got is None
    assert span("off") is span("other", micro=1)    # one shared no-op
    assert begin("off.queue") is None
    end(None, batch=1)
    assert [s.name for s in spans()] == ["before"]


def test_spans_nest_by_thread():
    with _profiler():
        with span("outer") as outer:
            with span("inner", micro=2) as inner:
                pass
            with span("sibling"):
                pass
        with span("root") as root:
            pass
    got = _by_name(spans())
    assert set(got) == {"outer", "inner", "sibling", "root"}
    assert got["inner"][0].parent == outer.id == got["sibling"][0].parent
    assert outer.parent is None and root.parent is None
    # a root's key is its own id, and the spans under it share it
    assert outer.key == outer.id and root.key == root.id != outer.key
    assert inner.key == outer.key == got["sibling"][0].key
    assert inner.attrs == {"micro": 2}
    me = threading.get_ident()
    assert all(s.thread == me for s in spans())
    for s in spans():
        assert s.start <= s.end
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_a_span_on_another_thread_is_that_threads_root():
    seen = {}

    def work():
        with span("worker") as w:
            seen["w"] = w

    with _profiler():
        with span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    got = _by_name(spans())
    assert got["worker"][0].parent is None
    assert got["worker"][0].thread == t.ident != got["main"][0].thread


def test_begin_end_crosses_threads_and_keeps_its_key():
    handles = {}

    def submit():
        handles["req"] = begin("engine.queue", request=41)

    with _profiler():
        t = threading.Thread(target=submit)
        t.start()
        t.join()
        with span("engine.batch") as batch:
            end(handles["req"], batch=batch.key)
            child = begin("child", parent=batch)
            end(child)
    got = _by_name(spans())
    q = got["engine.queue"][0]
    assert q.key == q.id and q.parent is None
    assert q.thread == t.ident != threading.get_ident()
    assert q.attrs == {"request": 41, "batch": batch.key}
    assert got["child"][0].parent == batch.id
    assert got["child"][0].key == batch.key


def test_threads_record_every_span_under_contention():
    """More threads than cores, each nesting spans and ending requests
    another thread began, with the interpreter switching threads every
    microsecond: no span is lost or doubled, parents stay on their
    thread."""
    import queue
    import sys
    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 200
    pending = queue.Queue()
    switch = sys.getswitchinterval()

    def work(k):
        for i in range(n_spans):
            with span("outer", micro=i):
                with span("inner"):
                    pending.put(begin("cross", request=(k, i)))
                end(pending.get(timeout=60))

    try:
        sys.setswitchinterval(1e-6)
        with _profiler():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    got = _by_name(spans())
    assert len(got["outer"]) == len(got["inner"]) == n_threads * n_spans
    assert len({s.attrs["request"] for s in got["cross"]}) == \
        n_threads * n_spans
    every = spans()
    assert len({s.id for s in every}) == len(every)
    outer = {s.id: s for s in got["outer"]}
    for s in got["inner"]:
        assert outer[s.parent].thread == s.thread


def test_a_span_ended_after_the_profiler_stops_is_dropped():
    with _profiler():
        h = begin("late")
        with span("kept"):
            pass
    end(h)
    assert [s.name for s in spans()] == ["kept"]


def test_a_new_session_drops_the_old_sessions_spans():
    with _profiler():
        with span("first"):
            pass
    with _profiler():
        pass                      # a session with no span drops nothing
    assert [s.name for s in spans()] == ["first"]
    with _profiler():
        with span("second"):
            pass
        with span("third"):
            pass
    assert [s.name for s in spans()] == ["second", "third"]


def test_a_span_holds_the_profilers_record_of_its_region():
    """Clock: each span's own record_function range and a range inside
    it lie within the span; the span's ends lie within 50 us of its
    range's (the median of 8; the first span warms the path)."""
    with _profiler() as prof:
        with span("warm"):
            pass
        for _ in range(8):
            with span("region"):
                with torch.profiler.record_function("inside"):
                    time.sleep(0.002)
    mine = _by_name(spans())["region"]
    own = sorted(_events(prof, "region"), key=lambda e: e.start_ns())
    inside = sorted(_events(prof, "inside"), key=lambda e: e.start_ns())
    assert len(mine) == len(own) == len(inside) == 8
    lead, tail = [], []
    for s, o, i in zip(mine, own, inside):
        for e in (o, i):
            assert s.start <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= s.end
        lead.append(o.start_ns() - s.start)
        tail.append(s.end - (o.start_ns() + o.duration_ns()))
    assert statistics.median(lead) <= 50_000, lead
    assert statistics.median(tail) <= 50_000, tail


# ---- the program's spans ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_git():
    from sasvqa_torch.models.presets import build_model
    torch.manual_seed(0)
    return build_model(TINY_GIT, device="cpu")


def test_scan_train_step_spans(tiny_git):
    from sasvqa_torch.data.pipeline import stack_microbatches
    from sasvqa_torch.train.steps import (create_train_state,
                                          make_scan_train_step)
    _, model = tiny_git
    rng = np.random.default_rng(1)
    micros = [{"text_input_ids": rng.integers(5, 500, (2, 8)),
               "text_attention_mask": np.ones((2, 8), np.int64),
               "visual_inputs": rng.normal(size=(2, NFRAME, IMG, IMG, 3))
               .astype(np.float32),
               "labels": rng.integers(5, 500, (2, 8))} for _ in range(3)]
    state = create_train_state(model, {"learning_rate": 1e-4,
                                       "grad_norm": 5.0}, 10, device="cpu")
    step = make_scan_train_step(3, device="cpu")
    batch = next(stack_microbatches(iter(micros), 3))
    with _profiler():
        state, _ = step(state, batch, 0)
    got = _by_name(spans())
    (update,) = got.pop("train.update")
    assert {k: len(v) for k, v in got.items()} == {
        "train.forward": 3, "train.backward": 3, "train.accumulate": 3,
        "train.optimizer": 1}
    for s in sum(got.values(), []):
        assert s.parent == update.id and s.key == update.key
        assert update.start <= s.start <= s.end <= update.end
    for name in ("train.forward", "train.backward", "train.accumulate"):
        assert [s.attrs["micro"] for s in got[name]] == [0, 1, 2]
    order = sorted(sum(got.values(), []), key=lambda s: s.start)
    assert [s.name.split(".")[1] for s in order] == \
        ["forward", "backward", "accumulate"] * 3 + ["optimizer"]


class _Rows:
    """A dataset whose groups are their indices."""

    def __len__(self):
        return 6

    def get_group(self, i):
        return i


def _collate(items, rng=None):
    return {"x": np.asarray(items, np.float32)}


def test_prefetcher_collates_under_input_collate_spans():
    from sasvqa_torch.data.pipeline import (DevicePrefetcher,
                                            infinite_batches)
    with _profiler():
        pre = DevicePrefetcher(infinite_batches(
            _Rows(), _collate, 2, np.random.default_rng(0)), depth=1,
            device="cpu")
        for _ in range(3):
            next(pre)
        pre.close()
    collates = _by_name(spans())["input.collate"]
    assert len(collates) >= 3
    assert {s.thread for s in collates} == {pre._thread.ident}
    assert all(s.parent is None for s in collates)


def test_greedy_generate_spans_one_decode_step_a_check(tiny_git):
    from sasvqa_torch.models.git import greedy_generate
    _, model = tiny_git
    model.eval()
    checks = []

    def all_done(done):
        checks.append(1)
        return bool(done.all())

    rng = np.random.default_rng(2)
    ids = rng.integers(5, 500, (2, 6))
    with _profiler():
        greedy_generate(model, ids, np.array([4, 6]),
                        rng.normal(size=(2, NFRAME, IMG, IMG, 3)).astype(
                            np.float32), max_text_len=10, device="cpu",
                        all_done=all_done)
    got = _by_name(spans())
    assert len(got["model.prompt_fill"]) == 1
    assert len(got["model.decode_step"]) == len(checks) >= 1
    fill = got["model.prompt_fill"][0]
    assert all(fill.end <= s.start for s in got["model.decode_step"])


def test_engine_spans(tiny_git):
    from sasvqa_torch.data.tokenization import make_test_wordpiece
    from sasvqa_torch.tasks.serve import QAEngine
    family, model = tiny_git
    model.eval()
    rng = np.random.default_rng(3)
    questions = ["what is the dog doing", "who is in the video",
                 "where is the cat running"]
    with _profiler():
        with QAEngine(model, family, make_test_wordpiece(), nframe=NFRAME,
                      samp_policy="uniform", batch_size=2, linger_ms=20.0,
                      max_txt_len=8, max_text_len=12, device="cpu") as eng:
            futs = [eng.submit(rng.normal(size=(K_STORED, IMG, IMG, 3))
                               .astype(np.float32), questions[i % 3])
                    for i in range(5)]
            for f in futs:
                f.result(timeout=300)
    got = _by_name(spans())
    queue = got["engine.queue"]
    assert len(queue) == 5
    assert len({q.key for q in queue}) == 5      # one id a request
    batches = {b.key: b for b in got["engine.batch"]}
    # the batches that ran, and the one whose drain took the shutdown
    assert len(batches) == eng.stats["batches"] + 1
    ran = {}
    for q in queue:
        b = batches[q.attrs["batch"]]
        assert b.start <= q.end <= b.end
        ran[b.key] = ran.get(b.key, 0) + 1
    assert sorted(ran.values()) == sorted(
        [2, 2, 1]), ran                          # 5 requests, batches of 2
    for name in ("engine.drain", "engine.collate", "engine.generate",
                 "engine.fetch", "engine.respond"):
        for s in got[name]:
            assert s.key in batches and s.thread == eng._thread.ident
    gen = {s.id: s for s in got["engine.generate"]}
    assert all(s.parent in gen for s in got["model.decode_step"])
    assert all(s.parent in gen for s in got["model.prompt_fill"])


def test_profile_steps_trace_holds_the_programs_spans(tmp_path):
    from sasvqa_torch.data.synthetic import make_synthetic_dataset
    from sasvqa_torch.tasks import run_video_qa
    paths = make_synthetic_dataset(str(tmp_path / "data"), num_videos=4,
                                   stored_frames=8, img_hw=IMG,
                                   questions_per_video=2)
    out = tmp_path / "run"
    cfg = {
        "task": "msvd_qa",
        "train_datasets": [{"name": "msvd_qa", "txt": paths["train"],
                            "img": paths["h5"]}],
        "val_datasets": [{"name": "msvd_qa", "txt": paths["val"],
                          "img": paths["h5"]}],
        "inference_txt_db": paths["test"], "inference_img_db": paths["h5"],
        "vid_mapping": paths["vidmapping"],
        "model": {"pretrained_model": "tiny-git", "vocab_size": 512},
        "img_size": IMG, "nframe": NFRAME, "samp_policy": "uniform",
        "max_n_example_per_group": 2, "train_batch_size": 2,
        "val_batch_size": 4, "inference_batch_size": 4,
        "gradient_accumulation_steps": 2, "num_train_epochs": 3,
        "min_valid_steps": 1, "num_valid": 1, "learning_rate": 1e-3,
        "decay": "constant", "optim": "adamw", "seed": 0,
        "platform": "cpu", "mesh_shape": [1], "bf16": 0,
        "output_dir": str(out), "max_txt_len": 16, "gen_max_new_tokens": 4,
        "profile_steps": 1}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    run_video_qa.main(["--task", "msvd_qa", "--config",
                       str(tmp_path / "cfg.json")])
    with open(out / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.update", "train.forward", "train.backward",
            "train.accumulate", "train.optimizer"} <= names
    assert os.path.exists(out / "trace" / "trace.json")
