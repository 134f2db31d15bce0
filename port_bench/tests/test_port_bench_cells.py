"""Whole runs of each cell's harness at tiny sizes on the CPU (the
harness's look for a chip is the only step skipped), sound and with the
timed path broken underneath; and on the card, each cell for a few
seconds."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import harness, run
from port_bench.tests import tiny

SEED = 4_294_967_311          # past 32 bits, as the driver's seeds are


def _execute(cell, fault=None, trace_on=False):
    return run.execute(cell, SEED, 0.5, trace_on, device="cpu",
                       fault=fault)


def _train_cell():
    return tiny.tiny_cell("git_msvd_train", "msvd_train")


def _answer_cell():
    cell = tiny.tiny_cell("git_msvd_answer", "msvd_answer")
    cell.traffic.update(clients=4, judged_requests=6)
    cell.traffic["engine"]["batch_size"] = 2
    return cell


@pytest.mark.parametrize("make", [_train_cell, _answer_cell],
                         ids=["train", "answer"])
def test_sound_run_is_correct(make):
    out = _execute(make())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("make,fault", [
    (_train_cell, "frozen_state"), (_train_cell, "half_batch"),
    (_answer_cell, "altered_token")])
def test_broken_timed_path_is_not_correct(make, fault):
    out = _execute(make(), fault=fault)
    assert not out["correct"], out["checks"]


def test_traced_run_reads_the_host_side_metrics():
    cell = _train_cell()
    cell.per_layer = [{"name": n, "unit": u} for n, u in (
        ("input_wait_ms.train", "ms"), ("train_mfu", "%"))]
    cell.readers = {m["name"]: harness.load_reader(m["name"])
                    for m in cell.per_layer}
    out = _execute(cell, trace_on=True)
    assert set(out["metrics"]) == {"input_wait_ms.train", "train_mfu"}
    assert out["correct"]


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then every loaded module's
    top-level name against JAX's and the JAX package's."""
    code = (
        "import sys\n"
        "from port_bench import harness, run\n"
        "from port_bench.tests import tiny\n"
        "cell = tiny.tiny_cell('git_msvd_train', 'msvd_train')\n"
        "run.execute(cell, 5, 0.2, False, device='cpu')\n"
        "print('BANNED', harness.banned_modules())\n")
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BANNED []" in out.stdout


def test_no_result_without_the_package(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench/, a
    run exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "port_bench")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "git_msvd_train", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.load(open(os.path.join(
        harness.ROOT, "BENCHMARK.json")))["workloads"]])
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_control_is_not_correct():
    """The reference on float8 operands, read against the f32 reference
    as the program is, fails one of the training cell's limits."""
    from port_bench.drivers import train
    cell = _train_cell()
    out = train.run(cell, SEED, 0.2, False, device="cpu",
                    calibrate=("control_fp8",))
    judged = harness.judge(out["controls"]["control_fp8"], cell.limits)
    assert not harness.verdict(judged), judged
