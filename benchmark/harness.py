"""The cells' drivers: set-up, the measured window, the traced stretch and
the comparison with the reference, for each ``entry`` a traffic mix names.

    train_step_chain  a single trainer's closed loop over
                      ``Distiller.train_step_chain`` (one CUDA-graph replay
                      of ``train.steps_per_launch`` steps a call);
    upstream_expert   one client's closed loop over
                      ``UpstreamExpert.forward``.

Both make their weights and audio on the device from the seed, warm up the
shapes their traffic uses in set-up, and hand the program only generated
inputs. The per-layer metrics are read by the files under ``metrics/``
from a ``Reading`` of the traced run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import time
from math import inf
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import compare, trace, traffic, weights
from .reference import serve as ref_serve
from .reference import train as ref_train

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "fithubert_tpu_torch"
TRACE_CALLS = {"train_step_chain": 12, "upstream_expert": 12}  # calls in the traced stretch
TRACE_AFTER = 3  # window calls before the traced stretch
TRACE_TAIL_S = 0.25  # profiled idle time after the stretch (``traced``)
CMP_CALLS = 3  # train calls compared: the eager first and two replays


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    mix: Dict
    lengths: Dict

    @classmethod
    def load(cls, name: str, bench_path: str) -> "Cell":
        with open(bench_path) as f:
            bench = json.load(f)
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in {bench_path}")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        with open(os.path.join(ROOT, conf["file"])) as f:
            config = json.load(f)
        mix = traffic.load_mix(entry["traffic"])
        return cls(name, entry, config, mix, traffic.load_mix(mix["lengths"]))


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics read from a traced run."""

    cell: Cell
    kind: str  # "train" or "serve"
    stretch: trace.Stretch
    units: List[Dict]  # per traced step or call: lengths, t_pad
    expected: Dict[str, int]  # family -> launches per unit
    host_ms: List[float]  # host ms of the window's calls that the metrics read
    power_limit: str


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<stem>.py``, the
    stem being the name up to its first dot (``host_ms`` reads
    ``host_ms.train`` and ``host_ms.serve``, each by the reading's kind),
    whose ``read(reading)`` returns its value, or None where the stretch
    holds nothing it reads."""
    import importlib.util

    stem = name.split(".")[0]
    spec = importlib.util.spec_from_file_location(f"bench_metric_{stem}",
                                                  os.path.join(HERE, "metrics", f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def experiment(cell: Cell, seed: int):
    from fithubert_tpu_torch.config import config_from_yaml_dict

    cfg = config_from_yaml_dict(cell.config["experiment"])
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=int(seed)))


def teacher_geometry(cell: Cell):
    from fithubert_tpu_torch.models.teacher import TeacherGeometry

    g = dict(cell.config["teacher_geometry"])
    g["conv_feature_layers"] = tuple(tuple(int(v) for v in c) for c in g["conv_feature_layers"])
    return TeacherGeometry(**g)


def launch_counts() -> Dict[str, int]:
    from fithubert_tpu_torch.ops.kernels import _build

    return dict(_build.LAUNCHES)


def family_launches(before: Dict[str, int], after: Dict[str, int], units: int) -> Dict[str, int]:
    """Launches per unit of each kernel family between two counts."""
    out = {}
    for fam, spec in trace.load_families().items():
        n = sum(after.get(k, 0) - before.get(k, 0) for k in spec["launch_counters"])
        if n % units:
            raise RuntimeError(f"{fam}: {n} launches over {units} units is no whole count")
        out[fam] = n // units
    return out


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def warm_profiler(dev) -> None:
    """Start the profiler once in set-up: its first start loads CUPTI."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)


def traced(fn_call: Callable[[bool], None], calls: int, dev) -> List:
    """The profiler's events over ``calls`` calls of ``fn_call(True)`` and
    a device sync, each in a span of the harness, after one call of
    ``fn_call(False)`` under the profiler but outside the stretch, which
    takes the profiler's start-up (its first activity buffers) out of it,
    and before ``TRACE_TAIL_S`` of sleep: the profiler drops the device
    records it places past its stop, and it can place the end of the
    stretch's work past the sync that waited for it. Reduced (``reduce``)
    once the window has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn_call(False)
        sync(dev)  # the stretch holds only its own calls' work
        for _ in range(calls):
            with record_function("bench.call"):
                fn_call(True)
        with record_function("bench.sync"):
            torch.cuda.synchronize(dev)
        time.sleep(TRACE_TAIL_S)
    return prof.profiler.kineto_results.events()


def reduce(events) -> trace.Stretch:
    return trace.from_profiler(events, trace.load_families())


# ------------------------------------------------------------------ train
def train_pool(cell: Cell, cfg, seed: int, dev):
    """The mix's pool of step batches in pinned host memory, each
    {"x": (A, B, T), "padding_mask": (A, B, T)} at the crop length, and
    each batch's rows' unpadded lengths."""
    a, b = cfg.train.accumulate_grad_batches, cfg.train.batch_size
    crop = cfg.data.max_wav_length
    n_pool = int(cell.mix["pool_steps"])
    rows = a * b
    lengths = [min(n, crop) for g in traffic.pool_groups(cell.lengths, n_pool, rows, seed)
               for n in g]
    wav, mask = weights.waveforms(lengths, crop, float(cell.lengths["amplitude"]),
                                  weights.generator(seed, "audio", dev), dev)
    pool = [{"x": pinned(wav[i * rows:(i + 1) * rows].view(a, b, crop)),
             "padding_mask": pinned(mask[i * rows:(i + 1) * rows].view(a, b, crop))}
            for i in range(n_pool)]
    return pool, [lengths[i * rows:(i + 1) * rows] for i in range(n_pool)]


def rand_layers(cfg, seed: int) -> Optional[List[int]]:
    """The random-layer mode's drawn layers, as the loop draws an epoch's."""
    if cfg.loss.distil_random_layer <= 0:
        return None
    return random.Random(seed).sample(range(cfg.distiller.encoder_layers - 1),
                                      cfg.loss.distil_random_layer)


def train_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, dev, t_start: float,
               fault: Optional[Callable] = None) -> Dict:
    from fithubert_tpu_torch.train.step import Distiller

    cfg = experiment(cell, seed)
    conf = cell.config
    k_steps = max(1, cfg.train.steps_per_launch)
    crop = cfg.data.max_wav_length
    sr = int(cell.lengths["sample_rate"])
    pool, pool_lengths = train_pool(cell, cfg, seed, dev)
    n_pool = len(pool)
    t_state = weights.teacher_state(conf, seed, dev)
    s_state = weights.student_state(conf, seed, dev)
    d = Distiller(cfg, t_state, s_state, device=dev,
                  num_training_steps=int(conf["num_training_steps"]),
                  teacher_geometry=teacher_geometry(cell))
    d.load_state_dict({"student": s_state, "optimizer": d.optimizer.state_dict(),
                       "step": int(conf["start_step"])})
    del t_state, s_state
    if fault is not None:
        fault(d)
    picks = rand_layers(cfg, seed)
    rand = None if picks is None else torch.tensor(picks, dtype=torch.long, device=dev)

    # what the reference compares, all read in set-up from the object the
    # window then drives: the first CMP_CALLS calls' losses (the first
    # call's K eager steps, then replays of the graph they were captured
    # in), the first step's gradient from AdamW's first moment as the
    # second eager step begins (a hook), and the parameters after the last
    # replay compared
    names = [n for n, _ in d.student.named_parameters()]
    beta1 = float(cfg.optimizer.betas[0])
    seen = {"steps": 0, "grad0": None}

    def observe(opt, _args, _kwargs):
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return
        seen["steps"] += 1
        if seen["steps"] == 2:
            seen["grad0"] = {n: opt.state[p]["exp_avg"].detach() / (1.0 - beta1)
                             for n, p in zip(names, d.params)}

    hook = d.optimizer.register_step_pre_hook(observe)
    cursor = [0]

    def next_batches():
        out, lens = [], []
        for _ in range(k_steps):
            i = cursor[0] % n_pool
            cursor[0] += 1
            out.append({k: v.to(dev, non_blocking=True) for k, v in pool[i].items()})
            lens.append(pool_lengths[i])
        return out, lens

    before = launch_counts()
    logs = list(d.train_step_chain(next_batches()[0], rand))
    after = launch_counts()
    hook.remove()
    # the first call runs K eager steps and captures them: 2K steps' launches
    expected = family_launches(before, after, 2 * k_steps) if dev.type == "cuda" else {}
    for _ in range(CMP_CALLS - 1):  # replays, each with new batches, lrs and draws
        logs += d.train_step_chain(next_batches()[0], rand)
    sync(dev)
    n_cmp = len(logs)
    prog = {"loss": [float(lg.to_floats()["loss"]) for lg in logs], "grad0": seen["grad0"],
            "params": {n: p.detach().clone() for n, p in zip(names, d.params)}}
    del logs
    if trace_on:
        warm_profiler(dev)
    sync(dev)
    setup_s = time.time() - t_start
    log_every = max(1, cfg.train.log_every)
    steps = calls = 0
    audio = 0.0
    host_ms: List[float] = []
    units: List[Dict] = []
    stretch = None
    drained = True
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace_on and stretch is None and calls == TRACE_AFTER:
            n = TRACE_CALLS["train_step_chain"]
            stretch_lens: List = []
            done: List = []  # every call's steps, the one before the stretch too

            def one(in_stretch: bool):
                bs, ls = next_batches()
                d.train_step_chain(bs, rand)
                done.extend(ls)
                if in_stretch:
                    stretch_lens.extend(ls)

            stretch = traced(one, n, dev)
            units = [{"lengths": ls, "t_pad": crop} for ls in stretch_lens]
            steps += len(done)
            calls += n + 1
            audio += sum(sum(ls) for ls in done) / sr
            drained = True
            continue
        batches, lens = next_batches()
        tc = time.perf_counter()
        out = d.train_step_chain(batches, rand)
        if drained:  # a call made with the card's queue empty: the host's own time
            host_ms.append((time.perf_counter() - tc) * 1e3)
        steps += k_steps
        calls += 1
        audio += sum(sum(ls) for ls in lens) / sr
        drained = steps % log_every < k_steps
        if drained:
            out[-1].to_floats()
        del out
    sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    reading = None
    if trace_on:
        reading = Reading(cell, "train", reduce(stretch), units, expected, host_ms, power_limit())
    del d
    free(dev)
    ref_batches = compared_batches(pool, n_cmp)
    readings = train_compare(cell, seed, prog, ref_batches, picks, dev)
    return {"attempted": steps, "setup_s": setup_s, "wall": wall, "peak": peak,
            "metrics": {"train_audio_s_per_s": audio / wall}, "reading": reading,
            "checks": readings}


def compared_batches(pool: Sequence[Dict], steps: int) -> List[Dict]:
    """The batches of the first ``steps`` steps, as the window's calls take
    them from the pool."""
    return [pool[i % len(pool)] for i in range(steps)]


def compared_steps(cfg) -> int:
    return CMP_CALLS * max(1, cfg.train.steps_per_launch)


def train_compare(cell: Cell, seed: int, prog: Dict, batches: Sequence[Dict], picks,
                  dev) -> Dict[str, float]:
    """The program's readings against the fp32 reference's; the worst
    leaves of each go to standard error."""
    ref = reference_steps(cell, seed, batches, picks, dev)
    leaves: Dict[str, str] = {}
    out = compare.train_readings(prog, ref, weights.student_state(cell.config, seed, dev),
                                 leaves)
    for k, v in leaves.items():
        print(f"{k} worst leaves: {v}", file=sys.stderr)
    return out


def reference_steps(cell: Cell, seed: int, batches, picks, dev, quant: str = "fp32",
                    fault: Optional[str] = None) -> Dict:
    conf = cell.config
    t_state = weights.teacher_state(conf, seed, dev)
    s_state = weights.student_state(conf, seed, dev)
    dev_batches = [{k: v.to(dev) for k, v in bt.items()} for bt in batches]
    with fp32_matmuls():
        return ref_train.run_steps(conf, t_state, s_state, dev_batches, picks, int(seed),
                                   quant=quant, fault=fault)


# ------------------------------------------------------------------ serve
def serve_pool(cell: Cell, seed: int, dev) -> List[List[np.ndarray]]:
    n_calls, batch = int(cell.mix["pool_calls"]), int(cell.mix["batch"])
    lengths = [n for g in traffic.pool_groups(cell.lengths, n_calls, batch, seed) for n in g]
    wav, _mask = weights.waveforms(lengths, max(lengths), float(cell.lengths["amplitude"]),
                                   weights.generator(seed, "audio", dev), dev)
    host = wav.cpu().numpy()
    return [[host[c * batch + i, :lengths[c * batch + i]] for i in range(batch)]
            for c in range(n_calls)]


def serve_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, dev, t_start: float,
               fault: Optional[Callable] = None) -> Dict:
    from fithubert_tpu_torch.export.expert import UpstreamExpert

    cfg = experiment(cell, seed)
    student = dataclasses.replace(cfg.distiller, init_conv_layers=False, init_encoder_layers=0)
    conf = cell.config
    quantum = int(cell.mix["length_quantum"])
    sr = int(cell.lengths["sample_rate"])
    pool = serve_pool(cell, seed, dev)
    pads = [traffic.quantize_length(max(len(w) for w in call), quantum) for call in pool]
    state = weights.student_state(conf, seed, dev, export=True)
    expert = UpstreamExpert(state, student, device=dev, length_quantum=quantum)
    del state
    if fault is not None:
        fault(expert)
    # warm up each padded length the pool holds, once
    before = launch_counts()
    warm = {}
    for i, t_pad in enumerate(pads):
        if t_pad not in warm:
            warm[t_pad] = i
            expert.forward(pool[i])
    sync(dev)
    expected = family_launches(before, launch_counts(), len(warm)) if dev.type == "cuda" else {}
    if trace_on:
        warm_profiler(dev)
    sync(dev)
    setup_s = time.time() - t_start
    rng = random.Random(seed)
    n_sample = int(cell.mix["sample_calls"])
    kept: List = []  # reservoir of (call index, pool index, outputs)
    lat_ms: List[float] = []
    host_ms: List[float] = []
    units: List[Dict] = []
    stretch = None
    audio = 0.0
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = calls % len(pool)
        if trace_on and stretch is None and calls == TRACE_AFTER:
            n = TRACE_CALLS["upstream_expert"]
            order = [(calls + j) % len(pool) for j in range(n + 1)]  # the first before it
            it = iter(order)

            def one(_in_stretch: bool):
                expert.forward(pool[next(it)])
                sync(dev)

            stretch = traced(one, n, dev)
            units = [{"lengths": [len(w) for w in pool[j]], "t_pad": pads[j]} for j in order[1:]]
            audio += sum(sum(len(w) for w in pool[j]) for j in order) / sr
            calls += n + 1
            continue
        tc = time.perf_counter()
        out = expert.forward(pool[i])
        host_ms.append((time.perf_counter() - tc) * 1e3)
        sync(dev)
        lat_ms.append((time.perf_counter() - tc) * 1e3)
        audio += sum(len(w) for w in pool[i]) / sr
        if len(kept) < n_sample:
            kept.append((calls, i, out))
        else:
            r = rng.randrange(len(lat_ms))
            if r < n_sample:
                kept[r] = (calls, i, out)
        calls += 1
    sync(dev)
    wall = time.perf_counter() - t0
    if len(lat_ms) >= 4:  # how steady the window was, half against half
        h = len(lat_ms) // 2
        print("serve window halves: " + "; ".join(
            f"median {np.median(v)!r} ms, p95 {np.percentile(v, 95)!r} ms"
            for v in (lat_ms[:h], lat_ms[h:])) + f"; host median {np.median(host_ms)!r} ms",
            file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    reading = None
    if trace_on:
        reading = Reading(cell, "serve", reduce(stretch), units, expected, host_ms, power_limit())
    del expert
    outs = [{k: (tuple(t.detach() for t in v) if isinstance(v, tuple) else v.detach())
             for k, v in o.items()} for _c, _i, o in kept]
    free(dev)
    readings = serve_compare(cell, seed, [pool[i] for _c, i, _o in kept], outs, dev)
    return {"attempted": calls, "setup_s": setup_s, "wall": wall, "peak": peak,
            "metrics": {"serve_audio_s_per_s": audio / wall,
                        "serve_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else inf},
            "reading": reading, "checks": readings}


def serve_compare(cell: Cell, seed: int, calls: Sequence, outs: Sequence[Dict], dev,
                  quant: str = "fp32") -> Dict[str, float]:
    state = weights.student_state(cell.config, seed, dev, export=True)
    quantum = int(cell.mix["length_quantum"])
    with fp32_matmuls():
        refs = [ref_serve.features(cell.config, state, wavs, quantum, dev, quant) for wavs in calls]
    return compare.serve_readings(outs, refs)


# ------------------------------------------------------------------ shared
class fp32_matmuls:
    """TF32 off for the reference's fp32 products and convolutions."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy of t, in pinned memory where there is a card."""
    t = t.cpu()
    return t.pin_memory() if torch.cuda.is_available() else t


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


DRIVERS = {"train_step_chain": train_cell, "upstream_expert": serve_cell}
