"""Percent of the device's idle time inside the profiled update (its
``train.update`` span less the union of the device's records) that
falls inside a span of the loop's thread: ``train.forward``,
``train.backward``, ``train.accumulate`` or ``train.optimizer``.  The
rest is the loop's glue between them."""

from port_bench import spans


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "train" or p is None:
        return None
    return spans.idle_attributed_share(spans.program_spans(),
                                       p["prof"]["records"])
