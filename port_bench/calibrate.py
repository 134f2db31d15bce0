"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 -m port_bench.calibrate --workload git_msvd_train \\
        --seeds 11,12,13 --control_seeds 11,12,13 --seconds 0 \\
        --out calibrate.jsonl

For each seed one run of the cell (its timed path and the reference, as
``port_bench.run`` makes it, with a window of ``--seconds``); on the
control seeds also the cell's controls read against the same reference
(the reference on float8 operands, and the faults the cell can have).
Every side, the program's and each control's, goes through the
comparison that decides ``correct`` (``harness.judge`` against the
cell's limits, then ``harness.verdict``): ``correct`` in a line maps
each side to its verdict.  One JSON line a seed, to standard output and
``--out``."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--controls", default="control_fp8,half_batch")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from port_bench.drivers import driver
    harness.keep_jax_out()
    run = driver(cell.traffic["driver"])
    controls = [c for c in args.controls.split(",") if c]
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = run(cell, seed, args.seconds, False, device="cuda", t0=t0,
                      calibrate=controls if seed in ctrl_seeds else ())
            # each side through the comparison that decides ``correct``
            verdicts = {side: harness.verdict(harness.judge(nums,
                                                            cell.limits))
                        for side, nums in dict(out["controls"], program=out[
                            "checks"]).items()}
            row = {"workload": args.workload, "seed": seed,
                   "checks": out["checks"], "controls": out["controls"],
                   "correct": verdicts,
                   "e2e": out["e2e"],
                   "reference_s": out["record"].get("reference_s"),
                   "run_s": time.perf_counter() - t0}
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
