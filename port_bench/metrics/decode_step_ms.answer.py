"""Mean host milliseconds of a greedy decode step in the profiled
stretch of traffic: from the read of the all-done flag, which waits for
the step before, through the step's launches (the program's
``model.decode_step`` spans)."""

from port_bench import spans


def read(record):
    if record.get("kind") != "answer":
        return None
    return spans.mean_ms(spans.named(spans.program_spans(),
                                     "model.decode_step"))
