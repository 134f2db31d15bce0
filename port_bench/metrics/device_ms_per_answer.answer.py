"""Device milliseconds an answer in the profiled stretch of traffic: the
union of the device's activity intervals over the answers that came
back in it.  The device's own work, which the host's pace does not
move."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "answer" or p is None or not p.get("answers"):
        return None
    return 1e3 * p["summary"]["busy_s"] / p["answers"]
