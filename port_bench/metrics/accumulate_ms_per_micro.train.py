"""Host milliseconds a micro-batch that the loop's thread spends adding
the micro's gradients into the accumulated mean in the profiled update
(the program's ``train.accumulate`` spans), over the update's micros."""

from port_bench import spans


def read(record):
    if record.get("kind") != "train":
        return None
    return spans.per_micro_ms(spans.program_spans(), "train.accumulate")
