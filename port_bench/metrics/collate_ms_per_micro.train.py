"""Mean host milliseconds of the prefetch thread's collation of one
micro-batch (the program's ``input.collate`` spans that end inside the
profiled update)."""

from port_bench import spans


def read(record):
    if record.get("kind") != "train":
        return None
    return spans.collate_ms(spans.program_spans())
