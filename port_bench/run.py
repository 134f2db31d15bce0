"""One run of one benchmark cell of ``sasvqa_torch`` on the GPU.

    python3 -m port_bench.run --workload git_msvd_train --seed 7 \\
        --seconds 20 --trace 0

From the checkout's root.  It prints, as standard output's last line,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number that decided ``correct`` beside its limit
(also standard error's last lines).  It exits non-zero with no result
when there is no CUDA device, or fewer than the cell asks for, or when a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from port_bench import harness  # noqa: E402

# every build and kernel cache of the run stays at a fixed path in the
# checkout
_CACHE = os.path.join(harness.ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(_CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(cell, seed: int, seconds: float, trace_on: bool,
            device: str = "cuda", t0: float = None, fault: str = None):
    """The result line's object for one run (``device`` 'cpu' runs the
    same path at a test's sizes)."""
    import torch
    from port_bench.drivers import driver
    harness.keep_jax_out()
    out = driver(cell.traffic["driver"])(
        cell, seed, seconds, trace_on, device=device,
        t0=T_START if t0 is None else t0, fault=fault)
    judged = harness.judge(out["checks"], cell.limits)
    rec = out["record"]
    if trace_on:
        values = {name: read(rec) for name, read in cell.readers.items()}
        metrics = harness.metric_block(cell.per_layer, values)
    else:
        metrics = harness.metric_block(cell.end_to_end, out["e2e"])
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": harness.verdict(judged),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace_on and rec.get("profiled") is not None:
        s = rec["profiled"]["summary"]
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = s["breakdown"]
    result["launches"] = out.get("launches", {})
    result["reference_s"] = rec.get("reference_s")
    result["stamps"] = {k: rec[k] for k in ("update_ends_s", "input_wait_s",
                                            "setup_marks_s") if k in rec}
    result["checks"] = judged
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); {n} visible", file=sys.stderr)
        return 2
    print(f"port_bench: {torch.cuda.get_device_name(0)}, power limit "
          f"{power_limit()}, torch {torch.__version__}", file=sys.stderr,
          flush=True)
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    banned = harness.banned_modules()
    if banned:
        print(f"port_bench: modules loaded that the benchmark may not "
              f"load: {banned}", file=sys.stderr)
        return 3
    print(f"port_bench: kernel launches {result.pop('launches')}; "
          f"reference {result.pop('reference_s')} s; window "
          f"{result.pop('stamps')}", file=sys.stderr, flush=True)
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
