"""1 - (union of the device's activity intervals / wall) over a profiled
stretch of the same closed-loop traffic after the window, in percent."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "answer" or p is None:
        return None
    s = p["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
