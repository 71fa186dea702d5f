#!/usr/bin/env python3
"""The readings that the limits of ``limits/<workload>.json`` are set
from, on the card at the cell's own size:

    python3 benchmark/control.py --workload <name> --seeds <n> ... [--seconds S]
        [--program] [--control] [--faults]

``--program``: the program's numbers, as a run compares them (a train
cell's first steps: the eager warm-up and two graph replays; a served
cell's sampled calls after a window of S seconds). ``--control``: the
reference computed in float8 (e4m3, a scale per tensor) in the program's
place, against the fp32 reference. ``--faults``: the faults of
``faults.py``: in a train cell the reference with half of each batch left
out or the layer norms left unchanged put in the program's place, and the
program with its graph replays on stale batches or frozen draws; in a
served cell an altered answer planted in the program. One JSON line per
seed and reading, with ``correct`` as the cell's limits judge it. Not run
by the benchmark's own runs.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import compare, faults, harness, weights

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    cell = harness.Cell.load(args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    train = cell.mix["entry"] == "train_step_chain"

    limits = compare.load_limits(args.workload)

    def emit(seed, what, readings, t0):
        print(json.dumps({"seed": seed, "reading": what, "seconds": time.time() - t0,
                          "correct": compare.judge(readings, limits), **readings}), flush=True)

    driver = harness.DRIVERS[cell.mix["entry"]]
    for seed in args.seeds:
        if args.program:
            t0 = time.time()
            emit(seed, "program", driver(cell, seed, args.seconds, False, dev, t0)["checks"], t0)
            harness.free(dev)
        if train and (args.control or args.faults):
            t0 = time.time()
            cfg = harness.experiment(cell, seed)
            pool, _ = harness.train_pool(cell, cfg, seed, dev)
            batches = harness.compared_batches(pool, harness.compared_steps(cfg))
            picks = harness.rand_layers(cfg, seed)
            ref = harness.reference_steps(cell, seed, batches, picks, dev)
            start = weights.student_state(cell.config, seed, dev)
            planted = (["fp8"] if args.control else []) + (
                ["half_batch", "frozen_norms"] if args.faults else [])
            for what in planted:
                t1 = time.time()
                quant, fault = ("fp8", None) if what == "fp8" else ("fp32", what)
                got = harness.reference_steps(cell, seed, batches, picks, dev, quant=quant,
                                              fault=fault)
                emit(seed, "control_fp8" if what == "fp8" else what,
                     compare.train_readings(got, ref, start), t1)
                del got
            del ref, start
            harness.free(dev)
        if train and args.faults:
            for name, fault in sorted(faults.REPLAY.items()):
                t0 = time.time()
                emit(seed, name, driver(cell, seed, args.seconds, False, dev, t0,
                                        fault=fault)["checks"], t0)
                harness.free(dev)
        if not train and args.control:
            t0 = time.time()
            pool = harness.serve_pool(cell, seed, dev)
            calls = pool[: int(cell.mix["sample_calls"])]
            state = weights.student_state(cell.config, seed, dev, export=True)
            quantum = int(cell.mix["length_quantum"])
            with harness.fp32_matmuls():
                from benchmark.reference import serve as ref_serve
                ctrl = [ref_serve.features(cell.config, state, w, quantum, dev, "fp8")
                        for w in calls]
            emit(seed, "control_fp8", harness.serve_compare(cell, seed, calls, ctrl, dev), t0)
            del ctrl, state
            harness.free(dev)
        if not train and args.faults:
            t0 = time.time()
            res = driver(cell, seed, args.seconds, False, dev, t0, fault=faults.altered)
            emit(seed, "altered", res["checks"], t0)
            harness.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
