"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limits file and metric reader loads by name, and every name
and unit keeps to the characters a name may have."""

import json
import os
import re

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_names_and_units():
    b = _bench()
    names = [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()[
    "workloads"]])
def test_cell_loads(workload):
    cell = harness.load_cell(workload)
    assert cell.chips in (1, 4)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in [e["name"] for e in cell.end_to_end]
        assert callable(cell.readers[m["name"]])


@pytest.mark.parametrize("config", [c["name"] for c in _bench()["configs"]])
def test_config_file(config):
    entry = {c["name"]: c for c in _bench()["configs"]}[config]
    assert entry["file"] == f"port_bench/configs/{config}.json"
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


def test_every_reader_reads_nothing_from_an_empty_record():
    b = _bench()
    for m in b["per_layer"]:
        assert harness.load_reader(m["name"])({}) is None


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()[
    "workloads"]])
def test_driver_and_family_found_by_name(workload):
    from port_bench import families
    from port_bench.drivers import driver
    cell = harness.load_cell(workload)
    assert callable(driver(cell.traffic["driver"]))
    fam = families.load(cell.config["family"])
    for attr in ("checkpoint_shapes", "is_layer_norm_weight", "trainable",
                 "micro_loss", "next_token_logits", "prompt", "leaf_norms",
                 "update_flops", "profiled"):
        assert callable(getattr(fam, attr)), attr
