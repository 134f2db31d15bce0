"""The window's model FLOPs (3 x the forward's products, attention only
where its mask lets it through, no recompute) over the window's
host-clock seconds times the bf16 peak, in percent."""

from port_bench.flops import PEAK_BF16_FLOPS


def read(record):
    if record.get("kind") != "train" or not record.get("updates"):
        return None
    return 100.0 * record["flops"] / (record["window_s"] * PEAK_BF16_FLOPS)
