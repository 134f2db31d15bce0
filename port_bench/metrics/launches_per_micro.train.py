"""Device kernel records of the profiled update over its micro-batches."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "train" or p is None:
        return None
    return p["summary"]["kernels"] / p["micros"]
