"""The GIT-mask attention kernels' share of their roofline in the
profiled update: the summed least seconds of every forward (K1) and
backward (K2) launch, max(operations / 989 TFLOP/s, bytes / 3.35 TB/s)
from the launch shapes, over their summed device seconds, in percent.
The dropout hash inside both is not counted, so the share is low by its
work.  Nothing is read when a launch's record is missing."""


def read(record):
    p = record.get("profiled")
    if record.get("kind") != "train" or p is None:
        return None
    k1, k2 = p.get("k1"), p.get("k2")
    expect = p["micros"] * record["config"]["num_hidden_layers"]
    if k1 is None or k2 is None or k1[0] != expect or k2[0] != expect:
        return None
    bound = p["bound_s"]["fwd"] + p["bound_s"]["bwd"]
    return 100.0 * bound / (k1[1] + k2[1])
