"""The port's AdamW under linear warmup and decay (fithubert_tpu_torch/
train/optim.py) against the JAX package's build_optimizer (optax.adamw
under join_schedules) for several steps on the same parameters and
gradients: the schedule's indexing (step 0 at lr 0), bias correction, eps
outside the square root, and weight decay scaled by the learning rate."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fithubert_tpu.config import OptimizerConfig as JOptimizerConfig
from fithubert_tpu.train.optim import build_optimizer as j_build_optimizer
from fithubert_tpu.train.optim import linear_warmup_decay as j_schedule
from fithubert_tpu_torch.config import OptimizerConfig
from fithubert_tpu_torch.train.optim import build_optimizer, linear_warmup_decay, optimizer_step

# fp32 parameter updates of ~lr in another order of operations
# (optax: sqrt(v / bc2); torch: sqrt(v) / sqrt(bc2)).
TOL = dict(atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("n,warm", [(20, 0.05), (10, 0.2), (7, 0.5), (3, 0.0)])
def test_schedule_matches_optax(n, warm):
    want = j_schedule(5e-4, n, warm)
    got = linear_warmup_decay(5e-4, n, warm)
    for s in range(n + 3):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0


def test_adamw_steps_match_optax():
    kw = dict(lr=5e-3, warmup_proportion=0.2, betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01)
    n_steps = 10
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-7, 1)).astype(np.float32)
              for s in shapes] for _ in range(6)]

    tx, sched = j_build_optimizer(JOptimizerConfig(**kw), n_steps)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, schedule = build_optimizer(tp, OptimizerConfig(**kw), n_steps)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        lr = optimizer_step(opt, schedule, step)
        assert lr == pytest.approx(float(sched(step)), rel=1e-6, abs=1e-12)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=f"step {step}",
                                       **TOL)
    assert step == 5
