"""Percent of the engine's dispatcher thread's wall, from its first
``engine.batch`` span of the profiled stretch to its last, spent
draining the queue, collating and answering (``engine.drain``,
``engine.collate``, ``engine.respond``): the host work that runs while
the device has no batch of the engine's queued."""

from port_bench import spans


def read(record):
    if record.get("kind") != "answer":
        return None
    return spans.serial_host_share(spans.program_spans())
