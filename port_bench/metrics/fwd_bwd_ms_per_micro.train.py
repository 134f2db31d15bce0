"""Host milliseconds a micro-batch that the loop's thread spends in the
model's forward and backward in the profiled update (the program's
``train.forward`` and ``train.backward`` spans, the launches and any
wait), over the update's micros."""

from port_bench import spans


def read(record):
    if record.get("kind") != "train":
        return None
    return spans.per_micro_ms(spans.program_spans(), "train.forward",
                              "train.backward")
