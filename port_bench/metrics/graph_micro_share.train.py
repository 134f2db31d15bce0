"""Percent of the profiled update's micro-batches that the train step
replayed from its captured CUDA graph: the update's ``train.forward``
spans whose ``graph`` attribute is 1, over all of them.  A program whose
spans carry no ``graph`` attribute reads nothing."""

from port_bench import spans


def share(recorded):
    _, under = spans.in_updates(recorded)
    marked = [s.attrs["graph"] for s in spans.named(under, "train.forward")
              if "graph" in s.attrs]
    if not marked:
        return None
    return 100.0 * sum(1 for g in marked if g == 1) / len(marked)


def read(record):
    if record.get("kind") != "train":
        return None
    return share(spans.program_spans())
