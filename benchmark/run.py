#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding the program (``fithubert_tpu_torch``)
on a machine with the cards the cell asks for; with none, or too few, it
exits with code 2 and prints no result. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
profiled stretch of the window. Both check the window's outputs against
the plain reference (``reference/``) and print each compared number
beside its limit, last on standard error and last in the result line.
"""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_checkout_caches() -> None:
    """Every build and kernel cache of the run inside the checkout, at fixed
    paths, so that only a checkout's first run builds."""
    cache = os.path.join(ROOT, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


FORBIDDEN = ("jax", "jaxlib", "flax", "fithubert_tpu")


def main(argv=None, device=None, cell=None, fault=None) -> int:
    """One run; ``device``, ``cell`` and ``fault`` are for the tests: a
    device that skips the look for a card, a cell of another size, a
    function planting a fault in the program's object."""
    import argparse
    import importlib.util
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import compare, harness

    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cell = cell or harness.Cell.load(args.workload, bench_path)
    chips = int(cell.workload["chips"])
    if device is None and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec(harness.PROGRAM) is None:
        print(f"run.py: the program {harness.PROGRAM} is not in {ROOT}: no result",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    driver = harness.DRIVERS[cell.mix["entry"]]
    res = driver(cell, args.seed, args.seconds, bool(args.trace), dev, process_start(),
                 fault=fault)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"run.py: the process loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 4

    metrics = {}
    if not args.trace:
        values = dict(res["metrics"], setup_s=res["setup_s"])
        for m in bench["end_to_end"]:
            if args.workload in m.get("workloads", [args.workload]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        reading = res["reading"]
        check_launches(reading)
        moved = {m["name"] for m in bench["end_to_end"]
                 if args.workload in m.get("workloads", [args.workload])}
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload] if m["moves"] in moved
                                          else []):
                continue
            value = harness.load_metric(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    print(f"setup_s {res['setup_s']!r}, window {res['wall']!r} s, attempted {res['attempted']}",
          file=sys.stderr)
    if args.trace:
        print(f"idle gaps by length [under ns, count, s]: {res['reading'].stretch.idle_by_size()}",
              file=sys.stderr)
    if args.trace and "mfu_pct" in " ".join(metrics):
        mfu = {k: v["value"] for k, v in metrics.items() if k.startswith("mfu_pct")}
        print(f"{mfu} at power limit: {res['reading'].power_limit}", file=sys.stderr)
    limits = compare.load_limits(args.workload)
    checks = res["checks"]
    correct = compare.judge(checks, limits)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind, "count": chips,
            "memory_peak_bytes": int(res["peak"])}
    out = {"correct": correct, "attempted": int(res["attempted"]), "failed": 0,
           "metrics": metrics, "device": info}
    if args.trace:
        st = res["reading"].stretch
        info["busy_s"], info["window_s"] = st.busy_s, st.window_s
        out["breakdown"] = st.breakdown()
        out["power_limit"] = res["reading"].power_limit
    out["checks"] = {k: {"value": checks.get(k), "limit": v} for k, v in limits.items()}
    for k, v in limits.items():
        print(f"check {k}: {checks.get(k)!r} (limit {v!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def check_launches(reading) -> None:
    """Every port kernel in the stretch belongs to a family of
    ``kernels/``, and each family launched what the cell's warm-up counted
    per step or call."""
    from benchmark import trace

    st = reading.stretch
    root = os.path.join(ROOT, "fithubert_tpu_torch", "csrc")
    unmapped = st.unmapped(trace.port_kernel_names(root))
    if unmapped:
        raise SystemExit(f"run.py: kernels of the program that no file of benchmark/kernels "
                         f"maps: {unmapped}")
    units = len(reading.units)
    for fam, per in reading.expected.items():
        seen = len(st.family(fam))
        if seen != per * units:
            raise SystemExit(f"run.py: the traced stretch holds {seen} launches of {fam}; its "
                             f"{units} units should launch {per} each")


if __name__ == "__main__":
    sys.path[0] = ROOT
    use_checkout_caches()
    sys.exit(main())
