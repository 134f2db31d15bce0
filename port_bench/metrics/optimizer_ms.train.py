"""Host milliseconds of the profiled update's optimizer call (the
program's ``train.optimizer`` span: clipping and the per-parameter
passes)."""

from port_bench import spans


def read(record):
    if record.get("kind") != "train":
        return None
    return spans.optimizer_ms(spans.program_spans())
