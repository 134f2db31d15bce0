"""Median milliseconds a request of the profiled stretch of traffic
waits in the engine's queue: from ``QAEngine.submit`` until the
dispatcher takes it into a batch (the program's ``engine.queue``
spans)."""

from port_bench import spans


def read(record):
    if record.get("kind") != "answer":
        return None
    return spans.queue_ms(spans.program_spans())
