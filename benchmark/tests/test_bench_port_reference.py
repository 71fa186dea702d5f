"""The plain reference against the program on the CPU, at a tiny size in
fp32: the same weights, audio and seeds give the same losses, gradients
and parameters (dropout masks worked out again from the seeds), and the
same served features. In bf16 the program departs by its rounding."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("kind", ["fithubert", "distilhubert"])
def test_train_steps_match_the_program_in_fp32(kind):
    res = harness.train_cell(tiny_cell(kind, fp16=False), 2 ** 31 + 21, 0.0, False, CPU,
                             time.time())
    assert res["checks"]["loss_gap"] < 1e-5
    assert res["checks"]["grad_gap"] < 1e-5
    assert res["checks"]["change_gap"] < 1e-4


@pytest.mark.parametrize("kind", ["fithubert", "distilhubert"])
def test_train_steps_in_bf16_depart_by_rounding(kind):
    res = harness.train_cell(tiny_cell(kind, fp16=True), 2 ** 31 + 22, 0.0, False, CPU,
                             time.time())
    assert 1e-6 < res["checks"]["loss_gap"] < 1e-2
    assert 1e-5 < res["checks"]["grad_gap"] < 0.05


def test_served_features_match_the_program_in_fp32():
    cell = tiny_cell("distilhubert", fp16=False, mix="serve_b32")
    res = harness.serve_cell(cell, 2 ** 31 + 23, 0.5, False, CPU, time.time())
    assert res["checks"]["feature_gap"] < 1e-5 and res["checks"]["mask_diff"] == 0
    assert res["attempted"] >= 1
