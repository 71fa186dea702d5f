"""The yardstick's copied counts against counts made by hand."""

import pytest

from benchmark import shapes, work


@pytest.mark.parametrize("x, spec, want_flops, want_bytes", [
    # one layer: 2 * B * T_out * d * k * c; x, weights, output once (bf16)
    ((2, 10, 4), [(8, 3, 1)], 2 * 2 * 8 * 8 * 3 * 4, 2 * (2 * 10 * 4 + 3 * 4 * 8 + 2 * 8 * 8)),
    # two layers, stride 2 then 1: T 9 -> 4 -> 3
    ((1, 9, 2), [(4, 3, 2), (6, 2, 1)],
     2 * 4 * 4 * 3 * 2 + 2 * 3 * 6 * 2 * 4,
     2 * (9 * 2 + 3 * 2 * 4 + 2 * 4 * 6 + 3 * 6)),
])
def test_conv_work_and_backward_by_hand(x, spec, want_flops, want_bytes):
    assert work.conv_work(x, spec) == (want_flops, want_bytes)
    flops, bytes_ = work.conv_bwd_work(x, spec)
    assert flops == 3 * want_flops
    # a0 and weights read (bf16) and written back (fp32); the gradient read once
    b, t, c = x
    wbytes = sum(k * ci * d for (d, k, _s), ci in zip(spec, [c] + [d for d, _k, _s in spec]))
    t_out = t
    for (_d, k, s) in spec:
        t_out = (t_out - k) // s + 1
    assert bytes_ == b * t * c * 6 + wbytes * 6 + b * t_out * spec[-1][0] * 2


@pytest.mark.parametrize("q, valid", [((2, 8, 3, 16), 12), ((1, 64, 2, 40), 64)])
def test_attention_counts_by_hand(q, valid):
    b, t, h, d = q
    n = b * t * h * d
    assert work.attn_work(q, valid) == (4 * h * d * t * valid, 8 * n + b * t + 4 * b * h * t)
    assert work.attn_prep_work(q) == (2 * n, 4 * n + 4 * b * h * t)
    tiles = -(-t // 64)
    assert work.attn_fused_work(q, valid) == (12 * h * d * t * valid,
                                              12 * n + b * t + 8 * b * h * t + 4 * tiles * n)
    assert work.attn_dq_sum_work(q) == ((tiles - 1) * n, 4 * tiles * n + 2 * n)
    assert work.prefix_work((b, t, d)) == (10 * b * t * d, 2 * (2 * b * t * d + 2 * b * d))


def test_bound_takes_the_larger_time():
    assert work.bound(989e12, 0) == (1.0, "operations")
    assert work.bound(0, 3.35e12) == (1.0, "bytes")


@pytest.mark.parametrize("t_wav", [16000, 192000])
def test_model_flops_by_hand(t_wav):
    """bench.py's counts: a one-layer stack, then an encoder of one layer."""
    assert work.conv_stack_flops([(4, 10, 5)], t_wav) == (2 * ((t_wav - 10) // 5 + 1) * 10 * 4,
                                                          (t_wav - 10) // 5 + 1)
    b, t, c, f = 2, 7, 8, 16
    per = 4 * 2 * b * t * c * c + 2 * 2 * b * t * t * c + 2 * 2 * b * t * c * f
    assert work.encoder_flops(b, t, c, f, 3, 4, 2) == 2 * b * t * 4 * c * (c // 2) + 3 * per


def test_release_step_counts_match_the_issue():
    """The teacher's forward of a 12-s row is ~180 GFLOP, the student's
    ~43 (FitHuBERT); HuBERT-Base's conv stack has 7 layers to 599 frames."""
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = json.load(open(os.path.join(root, "configs", "fithubert.json")))
    assert 170e9 < work.teacher_fwd_flops(cfg["teacher_geometry"], 192000) < 190e9
    assert 40e9 < work.student_fwd_flops(cfg["experiment"]["distiller"], 192000) < 45e9
    t, valid = shapes.teacher_attention(cfg["teacher_geometry"], [192000, 96000], 192000)
    assert (t, valid) == (599, 599 + 300)
    t, valid = shapes.student_attention(cfg["experiment"]["distiller"], [192000, 96000], 192000)
    assert t == 299 and valid == 299 + 149
