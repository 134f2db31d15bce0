"""The generic flash kernels' share of the device's work in the profiled
update: the device seconds of every K5 (forward), K6 dQ and K6 dK/dV
record over the union of the device's activity intervals, in percent.
Nothing is read where none of them ran."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "train" or p is None or "flash" not in p:
        return None
    secs = [h[1] for h in p["flash"].values() if h is not None]
    busy = p["summary"]["busy_s"]
    if not secs or busy <= 0:
        return None
    return 100.0 * sum(secs) / busy
