"""The three configurations' yardstick and reference, pinned to the numbers
the benchmark gave at commit 951174a, before a configuration could name its
reference module (``reference.load``): the model FLOPs and the launches of
each cell's pool of steps or calls at full widths, with the mfu and
roofline readers over them, and at the ``tiny.py`` cut the weights drawn
from a seed, the reference's first loss and its served features."""

import hashlib
import os
import types

import pytest
import torch

from benchmark import harness, reference, traffic, weights
from benchmark.reference import serve as ref_serve
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 2203
CPU = torch.device("cpu")

# cell: model FLOPs over the pool, {family: [launches, flops, bytes]}, and
# the readers' mfu, conv and attention roofline shares over a stretch of
# one second in which each family ran for one second
FULL = {
    "fithubert.train": (52946004429312,
                        {"conv": [80, 26013634215936, 34716844032],
                         "attention": [960, 3707438911488, 30504805632]},
                        5.353488819950657, 3.1889397057140667, 0.9105912128955219),
    "distilhubert.train": (51086774855680,
                           {"conv": [80, 37491707740160, 46204452864],
                            "attention": [320, 2539746975744, 18232023552]},
                           5.165497963162791, 4.386756236465237, 0.5442395090149253),
    "distilhubert.serve": (44312524507136,
                           {"conv": [32, 42577954340864, 86142615552],
                            "attention": [32, 1642429132800, 5390387200]},
                           4.48053837281456, 5.993495347923227, 0.16606967975733064),
}
# kind: sha256 (first 16 hex digits) of the teacher's, the student's and the
# served student's weights, and the reference's first-step loss
TINY = {
    "fithubert": ("ad46a0b3e67e8198", "91d144123455faa5", "40107b51053873eb",
                  1.4269770383834839),
    "distilhubert": ("ad46a0b3e67e8198", "fa9aba2aa835a32f", "60afbf76ca0f8430",
                     1.5546016693115234),
}
# two served calls: the last hidden state's and each layer's sum weighted by
# linspace(-1, 1), the first frame's first three features, padded frames
FEATURES = [
    (7.075028590532959, [7.027105944071749, 7.075028590532959],
     [1.425301432609558, -0.8008241057395935, -0.871681272983551], 2552),
    (7.487371298211787, [7.438357117053425, 7.487371298211787],
     [0.8481655716896057, -0.9958420991897583, 1.5779139995574951], 2491),
]


def pool_units(cell):
    """The pool's units as the drivers draw their lengths from ``SEED``."""
    if cell.mix["entry"] == "train_step_chain":
        cfg = harness.experiment(cell, SEED)
        rows = cfg.train.accumulate_grad_batches * cfg.train.batch_size
        crop = cfg.data.max_wav_length
        groups = traffic.pool_groups(cell.lengths, int(cell.mix["pool_steps"]), rows, SEED)
        return "train", [{"lengths": [min(n, crop) for n in g], "t_pad": crop} for g in groups]
    quantum = int(cell.mix["length_quantum"])
    groups = traffic.pool_groups(cell.lengths, int(cell.mix["pool_calls"]),
                                 int(cell.mix["batch"]), SEED)
    return "serve", [{"lengths": g, "t_pad": traffic.quantize_length(max(g), quantum)}
                     for g in groups]


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_counts_are_the_parents(name):
    cell = harness.Cell.load(name, os.path.join(harness.ROOT, "BENCHMARK.json"))
    kind, units = pool_units(cell)
    model = reference.load(cell.config)
    assert model.__name__ == "benchmark.reference.model"
    d = cell.config["experiment"]["distiller"]
    if kind == "train":
        flops = sum(model.kd_step_flops(d, cell.config["teacher_geometry"], u["lengths"])
                    for u in units)
        per_unit = model.step_launches
    else:
        live = 1 if d["layerwise_proj"] else 0
        flops = sum(model.student_fwd_flops(d, n, live_heads=live)
                    for u in units for n in u["lengths"])
        per_unit = model.call_launches
    families = {}
    for u in units:
        for fam, _what, fl, by in per_unit(cell.config, u["lengths"], u["t_pad"]):
            c = families.setdefault(fam, [0, 0, 0])
            c[0], c[1], c[2] = c[0] + 1, c[1] + fl, c[2] + by
    second = [types.SimpleNamespace(start=0, end=10 ** 9)]
    stretch = types.SimpleNamespace(window_s=1.0, family=lambda _fam: second)
    r = types.SimpleNamespace(cell=cell, kind=kind, units=units, stretch=stretch)
    read = [harness.load_metric(f"{m}.{kind}").read(r)
            for m in ("mfu_pct", "conv_roofline_pct", "attn_roofline_pct")]
    assert (flops, families, *read) == FULL[name]


def digest(state):
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(repr(tuple(v.shape)).encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("kind", sorted(TINY))
def test_tiny_weights_and_first_loss_are_the_parents(kind):
    cell = tiny_cell(kind)
    got = (digest(weights.teacher_state(cell.config, SEED, CPU)),
           digest(weights.student_state(cell.config, SEED, CPU)),
           digest(weights.student_state(cell.config, SEED, CPU, export=True)))
    assert got == TINY[kind][:3]
    cfg = harness.experiment(cell, SEED)
    pool, _ = harness.train_pool(cell, cfg, SEED, CPU)
    ref = harness.reference_steps(cell, SEED, pool[:1], harness.rand_layers(cfg, SEED), CPU)
    assert ref["loss"][0] == pytest.approx(TINY[kind][3], rel=1e-6)


def test_tiny_served_features_are_the_parents():
    cell = tiny_cell("distilhubert", mix="serve_b32")
    state = weights.student_state(cell.config, SEED, CPU, export=True)

    def weighted(x):
        x = x.double().flatten()
        return float((x * torch.linspace(-1, 1, x.numel(), dtype=torch.float64)).sum())

    for wavs, (last, layers, first, padded) in zip(harness.serve_pool(cell, SEED, CPU),
                                                   FEATURES):
        out = ref_serve.features(cell.config, state, wavs, int(cell.mix["length_quantum"]), CPU)
        assert weighted(out["last_hidden_state"]) == pytest.approx(last, abs=1e-4)
        assert [weighted(h) for h in out["hidden_states"]] == pytest.approx(layers, abs=1e-4)
        assert out["last_hidden_state"][0, 0, :3].tolist() == pytest.approx(first, abs=1e-5)
        assert int(out["padding_mask"].sum()) == padded
