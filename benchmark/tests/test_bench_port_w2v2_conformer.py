"""The wav2vec 2.0 Conformer configuration in the benchmark: its reference
module loads by name and keeps the contract; its FLOPs and the
relative-position core's work against a count by hand at a tiny size; no
kernel family's launches; its served cell end to end on the CPU at a tiny
size, fp32 and bf16; the cell's limits against the program, the final
LayerNorm left out and the float8 control; the new readers (the
conformer's spans' device time, the rel-pos roofline, the padded frames)
on a synthetic stretch whose host spans, runtime calls and device records
share correlation ids, and nothing read from a program that keeps no such
record; and, on the card, the cell traced and untraced (``-m gpu``)."""

import copy
import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program, reference, span_device, traffic, work
from benchmark.trace import Record, Stretch
from fithubert_tpu_torch.ops import conformer
from fithubert_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "w2v2_conformer_large.serve"
CPU = torch.device("cpu")
US = 1_000
T0 = 1_800_000_000_000_000_000


def full_config():
    with open(os.path.join(ROOT, "benchmark", "configs", "w2v2_conformer_large.json")) as f:
        return json.load(f)


def tiny_config():
    cfg = copy.deepcopy(full_config())
    cfg["experiment"]["distiller"].update(
        conv_feature_layers=[[32, 10, 5], [32, 3, 2], [48, 2, 2]], encoder_layers=2,
        encoder_embed_dim=64, encoder_ffn_embed_dim=96, encoder_attention_heads=4,
        depthwise_conv_kernel_size=7)
    return cfg


def tiny_cell(fp16: bool):
    cfg = tiny_config()
    cfg["experiment"]["train"]["use_fp16"] = fp16
    mix = dict(traffic.load_mix("serve_b32"), pool_calls=3, batch=4, sample_calls=2,
               length_quantum=1000)
    lengths = {"sample_rate": 16000, "amplitude": 0.1,
               "mixture": [{"weight": 0.85, "low_s": 0.16, "high_s": 0.3},
                           {"weight": 0.15, "low_s": 0.05, "high_s": 0.16}]}
    return harness.Cell(CELL, {"name": CELL, "chips": 1}, cfg, mix, lengths)


def test_the_configuration_names_its_reference_and_the_cell_loads():
    cell = harness.Cell.load(CELL, os.path.join(ROOT, "BENCHMARK.json"))
    model = reference.load(cell.config)
    assert model.__name__ == "benchmark.reference.w2v2_conformer"
    assert cell.mix["entry"] == "upstream_expert" and cell.workload["chips"] == 1
    d = cell.config["experiment"]["distiller"]
    widths = ("encoder_layers", "encoder_embed_dim", "encoder_attention_heads",
              "encoder_ffn_embed_dim", "depthwise_conv_kernel_size")
    assert [d[k] for k in widths] == [24, 1024, 16, 4096, 31]
    spec = model.student_spec(d, True)
    assert sum(torch.Size(s).numel() for _k, s, _kind, _c in spec) == 610_217_472
    cfg = harness.experiment(cell, 2 ** 31 + 5)
    assert cfg.distiller.dedicated_conformer and cfg.distiller.compute_dtype == "bfloat16"


def test_the_training_entries_raise_and_no_family_launches():
    cfg = full_config()
    model = reference.load(cfg)
    d = cfg["experiment"]["distiller"]
    assert model.call_launches(cfg, [16000] * 32, 272000) == []
    assert model.step_launches(cfg, [16000] * 32, 272000) == []
    for call in (lambda: model.teacher_spec({}), lambda: model.kd_step_flops(d, {}, [1]),
                 lambda: model.kd_loss({}, d, None, [], None),
                 lambda: model.student_forward({}, d, None, None, None, None, export=False)):
        with pytest.raises(NotImplementedError, match="no train cell"):
            call()


def test_flops_and_the_rel_pos_work_by_hand():
    """4000 samples at the tiny size: 799, 399, 199 frames; C 48, E 64,
    FFN 96, H 4 of 16, depthwise 7, 2 layers."""
    model = reference.load(tiny_config())
    d = tiny_config()["experiment"]["distiller"]
    t = 199
    relpos = 2 * 3 * 2 * t * t * 64
    assert model.relpos_work(d, [4000]) == (relpos, 2 * (6 * t - 1) * 64 * 2)
    assert model.relpos_work(d, [4000, 2500]) == (relpos + 2 * 3 * 2 * 124 * 124 * 64,
                                                  2 * (6 * t - 1 + 6 * 124 - 1) * 64 * 2)
    extractor = 2 * 799 * 10 * 1 * 32 + 2 * 399 * 3 * 32 * 32 + 2 * 199 * 2 * 32 * 48
    proj = 2 * t * 48 * 64
    layer = (2 * (2 * t * 64 * 96 + 2 * t * 96 * 64)  # two FFNs
             + 4 * 2 * t * 64 * 64 + 2 * (2 * t - 1) * 64 * 64  # q, k, v, out; linear_pos
             + 2 * t * 64 * 128 + 2 * t * 64 * 7 + 2 * t * 64 * 64)  # the conv module
    want = extractor + proj + 2 * layer + relpos
    assert model.student_fwd_flops(d, 4000, live_heads=0) == want


def test_the_served_cell_matches_the_program_in_fp32():
    res = harness.serve_cell(tiny_cell(fp16=False), 2 ** 31 + 41, 0.5, False, CPU, time.time())
    assert res["checks"]["feature_gap"] < 1e-5 and res["checks"]["mask_diff"] == 0
    assert res["attempted"] >= 1


def test_the_served_cell_in_bf16_departs_by_rounding():
    res = harness.serve_cell(tiny_cell(fp16=True), 2 ** 31 + 42, 0.5, False, CPU, time.time())
    assert 1e-4 < res["checks"]["feature_gap"] < 0.015 and res["checks"]["mask_diff"] == 0


def _stretch():
    """Two served calls of 100 us on the host. Each launches, inside
    ``conformer.rel_pos``, two kernels (runtime calls 1 and 2 of the call,
    running 10 us and 20 us on the card after the span has closed), inside
    ``conformer.conv_module`` one of 5 us and a memset of 1 us, inside
    ``extractor.unfused`` one of 7 us; one kernel launched outside every
    span (8 us) and a launch of the call before the stretch."""
    host, device = [], []
    for c in range(2):
        at, corr = T0 + c * 100 * US, 100 * (c + 1)
        host += [Record("bench.call", at, at + 100 * US),
                 Record("expert.model", at + 5 * US, at + 60 * US),
                 Record("extractor.unfused", at + 6 * US, at + 9 * US),
                 Record("cudaLaunchKernel", at + 7 * US, at + 8 * US, corr + 1),
                 Record("conformer.rel_pos", at + 10 * US, at + 20 * US),
                 Record("aten::einsum", at + 11 * US, at + 13 * US),
                 Record("cudaLaunchKernel", at + 12 * US, at + 13 * US, corr + 2),
                 Record("cuLaunchKernel", at + 15 * US, at + 16 * US, corr + 3),
                 Record("conformer.conv_module", at + 30 * US, at + 40 * US),
                 Record("cudaLaunchKernel", at + 31 * US, at + 32 * US, corr + 4),
                 Record("cudaMemsetAsync", at + 33 * US, at + 34 * US, corr + 5),
                 Record("cudaLaunchKernel", at + 50 * US, at + 51 * US, corr + 6)]
        device += [Record("void im2col(int)", at + 20 * US, at + 27 * US, corr + 1),
                   Record("void gemm(int)", at + 30 * US, at + 40 * US, corr + 2),
                   Record("void softmax(int)", at + 40 * US, at + 60 * US, corr + 3),
                   Record("void dwconv(int)", at + 60 * US, at + 65 * US, corr + 4),
                   Record("Memset (Device)", at + 65 * US, at + 66 * US, corr + 5),
                   Record("void layer_norm(int)", at + 70 * US, at + 78 * US, corr + 6)]
    host += [Record("conformer.rel_pos", T0 - 30 * US, T0 - 20 * US),  # before the stretch
             Record("cudaLaunchKernel", T0 - 25 * US, T0 - 24 * US, 7),
             Record("bench.sync", T0 + 200 * US, T0 + 201 * US)]
    device.append(Record("void gemm(int)", T0, T0 + 3 * US, 7))
    kernels = [r for r in device if not r.name.startswith("Memset")]
    return Stretch(T0, T0 + 201 * US, kernels, device, host, {})


def _reading(units=None):
    cell = SimpleNamespace(config=full_config())
    units = units or [{"lengths": [16000] * 32, "t_pad": 16000}] * 2
    return SimpleNamespace(kind="serve", stretch=_stretch(), units=units, cell=cell)


@pytest.mark.parametrize("metric, ms", [("relpos_ms.serve", 0.030),
                                        ("conv_module_ms.serve", 0.006),
                                        ("extractor_ms.serve", 0.007)])
def test_a_spans_device_time_is_what_its_runtime_calls_launched(metric, ms):
    assert harness.load_metric(metric).read(_reading()) == pytest.approx(ms)


def test_the_rel_pos_roofline_is_its_works_least_time_over_that_device_time():
    r = _reading()
    d = r.cell.config["experiment"]["distiller"]
    flops, bytes_ = reference.load(r.cell.config).relpos_work(d, [16000] * 32)
    assert flops == 32 * 24 * 6 * 49 * 49 * 1024  # 16000 samples: 49 frames
    least = max(flops / work.BF16_PEAK, bytes_ / work.HBM_BPS)
    got = harness.load_metric("relpos_roofline_pct.serve").read(r)
    assert got == pytest.approx(100.0 * 2 * least / (2 * 30e-6))


def test_the_padded_share_of_the_frames_served(monkeypatch):
    kept = [(T0 - 5 * US, "served_frames", 999),  # the call before the stretch
            (T0 + 2 * US, "served_frames", 1000), (T0 + 2 * US, "valid_frames", 700),
            (T0 + 102 * US, "served_frames", 1000), (T0 + 102 * US, "valid_frames", 900)]
    monkeypatch.setattr(profiling, "COUNTED", kept)
    assert harness.load_metric("pad_frames_pct.serve").read(_reading()) == pytest.approx(20.0)


@pytest.mark.parametrize("metric", ["relpos_ms.serve", "relpos_roofline_pct.serve",
                                    "conv_module_ms.serve", "extractor_ms.serve",
                                    "pad_frames_pct.serve"])
def test_a_program_without_the_record_reads_nothing(monkeypatch, metric):
    """An older program: no conformer or extractor span in the trace, no
    frame counters."""
    monkeypatch.setattr(program, "_profiling", lambda: SimpleNamespace(COUNTED=[]))
    host = [Record("bench.call", T0, T0 + 10 * US),
            Record("cudaLaunchKernel", T0 + US, T0 + 2 * US, 3)]
    device = [Record("void gemm(int)", T0 + 2 * US, T0 + 5 * US, 3)]
    st = Stretch(T0, T0 + 10 * US, device, device, host, {})
    r = SimpleNamespace(kind="serve", stretch=st, units=[{"lengths": [16000], "t_pad": 16000}],
                        cell=SimpleNamespace(config=full_config()))
    assert harness.load_metric(metric).read(r) is None
    assert span_device.launched(st, "conformer.rel_pos") == []


def test_the_whole_calls_share_of_the_peak_counts_the_conformers_flops():
    r = _reading()
    r.stretch.hi = r.stretch.lo + 10 ** 9  # one second
    d = r.cell.config["experiment"]["distiller"]
    per = reference.load(r.cell.config).student_fwd_flops(d, 16000, live_heads=0)
    got = harness.load_metric("mfu_pct.serve").read(r)
    assert got == pytest.approx(100.0 * 64 * per / work.BF16_PEAK)


def _no_final_norm(expert):
    expert.model.encoder.layer_norm = torch.nn.Identity()


def _shifted_by_one(x):
    b, h, t, _ = x.shape
    x = torch.nn.functional.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return x[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., 1:t + 1]


@pytest.mark.parametrize("fault", [None, "final_layer_norm_left_out", "control_fp8",
                                   "rel_shift_off_by_one"])
def test_the_cells_limits_judge_the_program_the_fault_and_the_control(capsys, monkeypatch,
                                                                      fault):
    """At the tiny size in bf16, under the cell's own limits: the program
    is correct; the encoder's final LayerNorm left out (the parent commit's
    conformer), ``rel_shift`` taking the column one position on, and the
    reference in float8 in its place are not."""
    from benchmark import compare, run, weights
    from benchmark.reference import serve as ref_serve

    cell = tiny_cell(fp16=True)
    seed = 2 ** 31 + 43
    limits = compare.load_limits(CELL)
    if fault == "control_fp8":
        pool = harness.serve_pool(cell, seed, CPU)[:2]
        state = weights.student_state(cell.config, seed, CPU, export=True)
        ctrl = [ref_serve.features(cell.config, state, w, 1000, CPU, "fp8") for w in pool]
        assert not compare.judge(harness.serve_compare(cell, seed, pool, ctrl, CPU), limits)
        return
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "0.2", "--trace", "0"]
    plant = _no_final_norm if fault == "final_layer_norm_left_out" else None
    if fault == "rel_shift_off_by_one":
        monkeypatch.setattr(conformer, "rel_shift", _shifted_by_one)
    assert run.main(argv, device="cpu", cell=cell, fault=plant) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is (fault is None), out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct_on_the_card(card, trace):
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                        str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] > 0 and out["device"]["count"] == 1
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if trace:
        want = {m["name"] for m in bench["per_layer"] if CELL in m["workloads"]}
        assert set(out["metrics"]) == want
        for name, m in out["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
    else:
        want = {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
        assert set(out["metrics"]) == want == {"serve_audio_s_per_s", "serve_p95_ms", "setup_s"}
