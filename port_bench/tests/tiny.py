"""Tiny cells for the CPU tests: the benchmark's own cells with every
size cut to what a test run holds (the widths too: these are tests of
the harness, not measurements)."""

from __future__ import annotations

import copy
import json
import os

from port_bench import harness

TINY_GIT = {
    "vocab_size": 2048, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "max_position_embeddings": 128,
    "vision_config": {"hidden_size": 32, "intermediate_size": 64,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "image_size": 32, "patch_size": 16,
                      "projection_dim": 32},
}


def _read(*parts):
    with open(os.path.join(harness.HERE, *parts)) as f:
        return json.load(f)


def tiny_git_config():
    c = _read("configs", "git_base.json")
    vis = dict(c["vision_config"], **TINY_GIT["vision_config"])
    c.update({k: v for k, v in TINY_GIT.items() if k != "vision_config"})
    c["vision_config"] = vis
    c["program_model"] = "tiny-git"
    return c


def tiny_traffic(name, videos=8, questions=48, batch=2, micros=3):
    t = copy.deepcopy(_read("traffic", f"{name}.json"))
    t["store"].update(num_videos=videos, questions={
        "train": questions, "val": 8, "test": 8})
    tc = t.get("task_config")
    if tc is not None:
        # f32, so that a sound run reads rounding alone
        tc.update(train_batch_size=batch, gradient_accumulation_steps=micros,
                  bf16=0)
    return t


def tiny_cell(name, traffic, limits=None, **traffic_kw):
    return harness.Cell(
        name=name, chips=1, config=tiny_git_config(),
        traffic=tiny_traffic(traffic, **traffic_kw),
        limits=limits or _read("limits", f"{name}.json"),
        end_to_end=[], per_layer=[])
