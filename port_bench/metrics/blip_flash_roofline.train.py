"""The generic flash kernels' share of their roofline in the profiled
update: the summed least seconds of every K5 (forward), K6 dQ and K6
dK/dV launch, max(operations / 989 TFLOP/s, bytes / 3.35 TB/s) from the
launch shapes, over their summed device seconds, in percent.  The
backward's ``rowsum_product`` prologue is in neither sum.  Nothing is
read unless each of the three kernels has one record a vision layer a
micro."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "train" or p is None or "flash" not in p:
        return None
    hits = p["flash"]
    if any(hits[k] is None or hits[k][0] != p["flash_launches"]
           for k in hits):
        return None
    bound = sum(p["flash_bound_s"].values())
    return 100.0 * bound / sum(h[1] for h in hits.values())
