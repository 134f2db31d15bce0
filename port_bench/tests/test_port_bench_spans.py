"""The readers of the program's spans: their arithmetic on spans made by
hand, and on a traced tiny run of each driver on the CPU, where each
reads a finite number in its own cell and nothing in the other."""

import math
from types import SimpleNamespace

import pytest
import torch

from port_bench import harness, run, spans
from port_bench.tests import tiny

SEED = 4_294_967_311

TRAIN = ("fwd_bwd_ms_per_micro.train", "accumulate_ms_per_micro.train",
         "optimizer_ms.train", "collate_ms_per_micro.train",
         "idle_attributed_share.train")
ANSWER = ("queue_ms.answer", "decode_step_ms.answer",
          "serial_host_share.answer")


def _span(name, start, end, key, thread=1, sid=None):
    return SimpleNamespace(name=name, start=start, end=end, key=key,
                           thread=thread, id=sid)


def test_idle_ns_by_hand():
    # window 0-100; device busy 10-20 and 50-90; host 0-30 and 85-100
    idle, inside = spans.idle_ns((0, 100), [(10, 20), (50, 90), (95, 200)],
                                 [(0, 30), (85, 100)])
    assert idle == 100 - 10 - 40 - 5
    assert inside == 10 + 10 + 0 + 5       # 0-10, 20-30, 90-95


def test_train_arithmetic_by_hand():
    u = _span("train.update", 0, 1_000_000, key=9)
    s = [u,
         _span("train.forward", 0, 200_000, 9),
         _span("train.backward", 200_000, 500_000, 9),
         _span("train.accumulate", 500_000, 600_000, 9),
         _span("train.forward", 600_000, 700_000, 9),
         _span("train.backward", 700_000, 800_000, 9),
         _span("train.accumulate", 800_000, 850_000, 9),
         _span("train.optimizer", 850_000, 950_000, 9),
         _span("input.collate", 900_000, 1_000_000, 3, thread=2),
         _span("input.collate", 0, 2_000_000, 4, thread=2),
         _span("train.forward", 5_000_000, 6_000_000, 11)]
    assert spans.per_micro_ms(s, "train.forward", "train.backward") == \
        pytest.approx(0.35)
    assert spans.per_micro_ms(s, "train.accumulate") == pytest.approx(0.075)
    assert spans.optimizer_ms(s) == pytest.approx(0.1)
    assert spans.collate_ms(s) == pytest.approx(0.1)
    # the leaves cover 0-950 us; the device busy 0-100 and 940-1000 us
    # leaves it idle 100-940 us, all inside them
    recs = [("k", 0, 100_000), ("k", 940_000, 1_000_000)]
    assert spans.idle_attributed_share(s, recs) == pytest.approx(100.0)
    recs = [("k", 0, 100_000)]          # idle 100-1000; leaves to 950
    assert spans.idle_attributed_share(s, recs) == \
        pytest.approx(100.0 * 850 / 900)


def test_answer_arithmetic_by_hand():
    s = [_span("engine.batch", 0, 100, 1), _span("engine.drain", 0, 10, 1),
         _span("engine.collate", 10, 30, 1),
         _span("engine.respond", 80, 100, 1),
         _span("engine.batch", 100, 200, 2),
         _span("engine.drain", 100, 120, 2),
         _span("engine.collate", 300, 400, 7),     # not of a batch
         _span("engine.queue", 0, 2_000_000, 5),
         _span("engine.queue", 0, 4_000_000, 6),
         _span("engine.queue", 0, 9_000_000, 8),
         _span("model.decode_step", 0, 1_000_000, 1),
         _span("model.decode_step", 0, 3_000_000, 1)]
    assert spans.serial_host_share(s) == pytest.approx(100.0 * 70 / 200)
    assert spans.queue_ms(s) == pytest.approx(4.0)
    assert spans.mean_ms(spans.named(s, "model.decode_step")) == \
        pytest.approx(2.0)


def test_no_spans_read_nothing():
    assert spans.serial_host_share([]) is None
    assert spans.queue_ms([]) is None
    assert spans.per_micro_ms([], "train.forward") is None
    assert spans.optimizer_ms([]) is None
    assert spans.collate_ms([]) is None
    assert spans.idle_attributed_share([], []) is None


def _traced(cell):
    from port_bench.drivers import driver
    out = driver(cell.traffic["driver"])(cell, SEED, 0.5, True,
                                         device="cpu")
    return out["record"]


def _readers(names):
    return {n: harness.load_reader(n) for n in names}


@pytest.fixture(scope="module")
def traced_records():
    """The train cell's record with the readers' values while its spans
    are the newest, then the answer cell's.  The prefetch thread collates
    the next update's micros from the update's start, and the profiler
    must have started while it still does: the train cell takes 64
    micros an update, and a session before the run takes the profiler's
    first start in the process (hundreds of ms on the CPU)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pass
    train = tiny.tiny_cell("git_msvd_train", "msvd_train", micros=64)
    rec_t = _traced(train)
    read_t = {n: r(rec_t) for n, r in _readers(TRAIN + ANSWER).items()}
    answer = tiny.tiny_cell("git_msvd_answer", "msvd_answer")
    answer.traffic.update(clients=4, judged_requests=6)
    answer.traffic["engine"]["batch_size"] = 2
    rec_a = _traced(answer)
    read_a = {n: r(rec_a) for n, r in _readers(TRAIN + ANSWER).items()}
    return read_t, read_a


@pytest.mark.parametrize("name", TRAIN)
def test_train_readers_read_the_train_cell_alone(traced_records, name):
    read_t, read_a = traced_records
    assert read_t[name] is not None and math.isfinite(read_t[name])
    assert read_t[name] >= 0
    assert read_a[name] is None


@pytest.mark.parametrize("name", ANSWER)
def test_answer_readers_read_the_answer_cell_alone(traced_records, name):
    read_t, read_a = traced_records
    assert read_a[name] is not None and math.isfinite(read_a[name])
    assert read_a[name] >= 0
    assert read_t[name] is None


def test_shares_are_percent(traced_records):
    read_t, read_a = traced_records
    assert 0 <= read_t["idle_attributed_share.train"] <= 100
    assert 0 < read_a["serial_host_share.answer"] <= 100


def test_a_session_without_spans_reads_nothing():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        from sasvqa_torch.core.profiling import span
        with span("other"):
            pass
    rec = {"kind": "train", "profiled": {"prof": {"records": []}}}
    for name, read in _readers(TRAIN).items():
        assert read(rec) is None, name
    rec = {"kind": "answer"}
    for name, read in _readers(ANSWER).items():
        assert read(rec) is None, name


def test_a_traced_run_prints_the_new_metrics():
    cell = tiny.tiny_cell("git_msvd_train", "msvd_train", micros=64)
    cell.per_layer = [{"name": n, "unit": "ms"} for n in TRAIN]
    cell.readers = _readers(TRAIN)
    out = run.execute(cell, SEED, 0.5, True, device="cpu")
    assert set(out["metrics"]) == set(TRAIN)
    assert out["correct"]
