"""One encoder layer of a training forward, with its own draws and, under
``checkpoint_activations``, activation checkpointing: the counterpart of the
JAX package's ``nn.remat`` of each encoder layer
(``fithubert_tpu/ops/transformer.py:355-360, 378-380, 483-489``,
``fithubert_tpu/ops/conformer.py:402-406``).

``torch.utils.checkpoint`` (non-reentrant) drops the layer's activations
after its forward and recomputes them in the backward. The recompute gives
the forward's values bit for bit because nothing it reads has moved: the
layer's dropout draws come from its own slots of the seed table
(``DropoutRNG.fork``), which it reads again, and no torch generator is
involved (so torch's RNG state is not saved). Two things of the forward
must not happen twice, and do not:
- the BatchNorm running statistics (``RowMaskedBatchNorm``) move in the
  forward only: the recompute runs with their ``update_stats`` off, as the
  JAX remat's mutated ``batch_stats`` come from the forward;
- a sum over data-parallel ranks in the layer (the BatchNorm's
  ``sum_over_ranks``) runs again in the recompute, on the same inputs, so
  it gives the forward's sum; every rank recomputes the same layers in the
  same backward order, so the collectives pair up.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def _stats_frozen(module: nn.Module) -> Iterator[None]:
    """Every submodule with an ``update_stats`` flag leaves its running
    statistics where they are."""
    mods = [m for m in module.modules() if getattr(m, "update_stats", False)]
    for m in mods:
        m.update_stats = False
    try:
        yield
    finally:
        for m in mods:
            m.update_stats = True


def run_layer(layer: nn.Module, fn: Callable, remat: bool, *tensors):
    """``fn(*tensors)``, the forward of ``layer``; checkpointed when
    ``remat`` and autograd records, the recompute leaving the running
    statistics alone."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*tensors)
    return checkpoint(fn, *tensors, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _stats_frozen(layer)))
