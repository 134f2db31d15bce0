"""One module a model family: ``port_bench/families/<family>.py``, found
by the configuration file's ``family``.  It gives the drivers what is
the family's own: the published checkpoint's shapes, the plain
reference's loss and next-token logits, where each program leaf lives in
the checkpoint, and the model FLOPs and kernel bounds of an update."""

import importlib


def load(family: str):
    return importlib.import_module(f"port_bench.families.{family}")
