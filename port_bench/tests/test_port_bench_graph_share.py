"""``graph_micro_share.train``: the share of an update's micros replayed
from the train step's captured graph, on spans made by hand and on a
traced tiny run on the CPU (where every micro runs eagerly)."""

from types import SimpleNamespace

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny
from port_bench.tests.test_port_bench_spans import SEED, _traced

NAME = "graph_micro_share.train"


def _span(name, key, **attrs):
    return SimpleNamespace(name=name, start=0, end=1, key=key, thread=1,
                           id=None, attrs=attrs)


def test_share_by_hand():
    share = harness.load_reader(NAME).__globals__["share"]
    s = [_span("train.update", 9),
         _span("train.forward", 9, micro=0, graph=0),
         _span("train.forward", 9, micro=1, graph=1),
         _span("train.forward", 9, micro=2, graph=1),
         _span("train.forward", 9, micro=3, graph=1),
         _span("train.backward", 9, micro=0),
         _span("train.forward", 11, micro=0, graph=0)]   # not of an update
    assert share(s) == pytest.approx(75.0)
    assert share(s[:2]) == 0.0
    # spans without the attribute (a program without the graph) and no
    # spans at all read nothing
    assert share([_span("train.update", 9),
                  _span("train.forward", 9, micro=0)]) is None
    assert share([]) is None


def test_a_run_without_spans_reads_nothing():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        from sasvqa_torch.core.profiling import span
        with span("other"):
            pass
    read = harness.load_reader(NAME)
    assert read({"kind": "train"}) is None
    assert read({"kind": "answer"}) is None


def test_a_traced_cpu_run_replays_nothing():
    read = harness.load_reader(NAME)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pass
    rec = _traced(tiny.tiny_cell("git_msvd_train", "msvd_train", micros=4))
    assert read(rec) == 0.0
