"""Device milliseconds a micro-batch in the profiled update: the union
of the device's activity intervals over the update's micros.  The
device's own work, which the host's pace does not move."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "train" or p is None or not p.get("micros"):
        return None
    return 1e3 * p["summary"]["busy_s"] / p["micros"]
