"""One driver a kind of traffic: ``port_bench/drivers/<driver>.py``,
found by the traffic file's ``driver``, with a ``run(cell, seed,
seconds, trace_on, device=, t0=, fault=, calibrate=)`` that returns the
result line's fields."""

import importlib


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}").run
