"""One run of one cell of the benchmark of `animals3d_tpu_torch`, the
PyTorch and CUDA port, on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout. The cell's files (`workloads/<cell>.json`,
`configs/<config>.json`) say what to build and drive; set-up, the timed
window and the check against the plain reference are the entry's
(`harness/entries/<entry>.py`). With `--trace 0` the last line of
standard output holds the cell's end-to-end metrics; with `--trace 1`,
after the same window, a short traced window gives its per-layer metrics
(`metrics/<metric>.py`) and the trace's breakdown. Every run checks what
the timed path produced against the reference and prints each number
compared beside its limit, as the last lines of standard error and last
in the result's line. Without the cards the cell asks for, or with a
module of JAX or of the JAX package loaded, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# the kernel caches of the program stay in the checkout, at fixed paths
CACHE = os.path.join(HERE, ".cache")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace_on: bool,
             device="cuda", side=None) -> dict:
    """Set up, time, (trace,) check; returns the result's fields."""
    from harness import compare, spec
    from harness.entries import common
    entry = cell.entry
    t0 = time.perf_counter()
    st = entry.setup(cell, seed, device, side=side)
    setup_s = time.perf_counter() - t0
    setup_peak = common.peak_bytes(device)
    e2e = entry.window(st, seconds)
    e2e["setup_s"] = setup_s
    peak = max(setup_peak, st.window["peak_bytes"])
    ctx = None
    if trace_on:
        common.reset_peak(device)
        ctx = entry.traced(st)
        peak = max(peak, common.peak_bytes(device))
    readings, counts = entry.check(st, counting=trace_on)
    correct, checks = compare.check(readings, cell.limits)
    units = {}
    if trace_on:
        rctx = {"entry": cell.workload["entry"], "trace": ctx,
                "window": st.window, "flops": counts.get("flops"),
                "bounds": counts.get("bounds")}
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(rctx)
            if value is not None:
                metrics[m["name"]] = value
                units[m["name"]] = m["unit"]
    else:
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    return {"correct": correct, "attempted": st.window["steps"],
            "failed": sum(1 for k, v in checks.items()
                          if not (v["value"] is not None
                                  and v["value"] <= v["limit"])),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in metrics.items()},
            "peak": peak, "trace": ctx, "checks": checks,
            "detail": counts.get("detail"), "setup_parts": st.setup_parts,
            "window": st.window, "bounds": counts.get("bounds")}


def main(argv=None) -> int:
    args = _args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    if REPO not in sys.path:
        sys.path.append(REPO)
    from harness import guard, spec
    cell = spec.load_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = guard.forbidden()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["peak"],
              "power_limit_w": _power_limit()}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = out["trace"]["breakdown"]
    print(f"set-up: {json.dumps(out['setup_parts'])}; window: "
          f"{json.dumps(out['window'])}", file=sys.stderr)
    if out["detail"]:
        print(f"detail: {json.dumps(out['detail'])}", file=sys.stderr)
    if out["bounds"]:
        print(f"bounds (ms a launch): {json.dumps(out['bounds'])}",
              file=sys.stderr)
    print(f"device: {device['kind']}, power limit "
          f"{device['power_limit_w']} W", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = out["checks"]
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
