"""GELU in the two flavours the JAX package uses, the conformer's SiLU and
GLU, and ``ACTIVATIONS``, the FFN's table of ``activation_fn``
(``fithubert_tpu/ops/transformer.py:33-41``).

``gelu_exact`` is the erf form (``fithubert_tpu/ops/activations.py:28``): the
FFN, the positional conv, and every GELU in fp32. ``gelu_tanh`` is the tanh
approximation that the fused conv stack applies whenever its dtype is not
fp32 (``ops/pallas/conv_frontend.py:85-91,211-212,252``), and what
``gelu_fast`` and ``gelu_accurate`` name (``jax.nn.gelu(approximate=True)``).
Both compute in fp32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``0.5 * x * (1 + erf(x / sqrt(2)))``."""
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounded to x's dtype after each of the two ops, as
    ``jax.nn.silu`` computes it (the conformer's FFN and conv module)."""
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": gelu_exact,
    "gelu_fast": gelu_tanh,
    "gelu_accurate": gelu_tanh,
    "tanh": torch.tanh,
    "linear": lambda x: x,
    "swish": silu,
}


def glu(x: torch.Tensor) -> torch.Tensor:
    """``a * sigmoid(b)`` over the two halves of the last dim, as
    ``jax.nn.glu(x, axis=-1)``."""
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)
