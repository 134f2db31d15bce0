"""What a cell is, found by name, and how a run reports.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and traffic mix; their files are
``port_bench/configs/<config>.json`` and ``port_bench/traffic/<traffic>
.json``, the limits of the comparison that decides ``correct`` are
``port_bench/limits/<cell>.json``, and each per-layer metric's reader is
``port_bench/metrics/<metric>.py`` (a ``read(record)`` that returns a
number, or None when the run gives it nothing to read).  A new cell or
metric is new files and new entries, never an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "optax", "sasvqa_tpu")


def _json(*parts: str) -> Any:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Callable[[Dict[str, Any]], Optional[float]]] = \
        field(default_factory=dict)


def _reports(metric: Dict[str, Any], cell: str,
             e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str) -> Cell:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json("configs", f"{w['config']}.json")
    if os.path.join(HERE, "configs", f"{w['config']}.json") != \
            os.path.join(ROOT, configs[w["config"]]["file"]):
        raise ValueError(f"config {w['config']}: file is not "
                         f"port_bench/configs/{w['config']}.json")
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, name, [m["name"]])]
    e2e_names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    cell = Cell(name=name, chips=int(w["chips"]), config=cfg,
                traffic=_json("traffic", f"{w['traffic']}.json"),
                limits=_json("limits", f"{name}.json"), end_to_end=e2e,
                per_layer=layer)
    cell.readers = {m["name"]: load_reader(m["name"]) for m in layer}
    return cell


def keep_jax_out() -> None:
    """TensorBoard, which the task loop's logger mirrors to, imports
    TensorFlow when it is installed, and TensorFlow may import JAX: its
    ``notf`` marker makes TensorBoard use its own stub of TensorFlow's
    API instead (the summaries are written all the same)."""
    import types
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))


def banned_modules() -> List[str]:
    """Whole top-level names of loaded modules that the benchmark may
    not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def metric_block(specs: List[Dict[str, Any]],
                 values: Dict[str, Optional[float]]) -> Dict[str, Any]:
    out = {}
    for m in specs:
        v = values.get(m["name"])
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(checks: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit."""
    missing = sorted(set(limits) - set(checks))
    if missing:
        raise RuntimeError(f"numbers not compared: {missing}")
    return {k: {"value": float(checks[k]), "limit": float(limits[k])}
            for k in limits}


def verdict(judged: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] == v["value"] and v["value"] <= v["limit"]
               for v in judged.values())


def print_result(result: Dict[str, Any]) -> None:
    """The checks on standard error's last lines, then the result as
    standard output's last line with the checks as its last key."""
    checks = result.pop("checks")
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
