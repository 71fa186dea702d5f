"""int8 matmuls for the frozen teacher and for serving
(``fithubert_tpu/ops/quant.py``), with the JAX package's recipe:

  - weights: per-output-channel symmetric int8 from the weight as stored
    (fp32 for a served student, the bf16 cast for the frozen teacher),
    the scale max|w| / 127 in fp32, floored at 1e-12;
  - activations: per-token symmetric int8 the same way, at every call;
  - the product: s8 x s8 -> s32 (``torch._int_mm``: cuBLASLt on the card),
    then the fp32 dequant ``acc * x_scale * w_scale`` in that order, cast
    to the compute dtype before the bias is added.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payloads, the scales and the int32 accumulators equal the JAX package's.

A Linear at one of JAX's ``dense_cls`` call sites is made with ``dense(...,
quantize=True)``; ``ops/attention.py linear`` then quantizes its weight at
every call, as JAX's ``QuantDense`` does. ``prequantize_`` stores the int8
payload and scale of every such Linear once, for a model whose weights no
longer change (``TeacherModel.freeze``, ``UpstreamExpert``): the same
payloads, without the per-call pass over the weights. The state dict keeps
the float weights either way. Training through int8 matmuls is refused
(``train/step.py``): round() has no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

# amax is 0 for an all-zero row or channel (a row of padding only): the
# floor keeps the scale finite and the quantized values 0
SCALE_FLOOR = 1e-12


def _quantize(x32: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x32.abs().amax(dim=dim, keepdim=True) / 127.0, min=SCALE_FLOOR)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Linear's (N, K) weight -> ((N, K) int8, (N,) fp32 scale), one
    scale per output channel (JAX ``quantize_weight`` on the (K, N) kernel)."""
    q, scale = _quantize(w.float(), 1)
    return q, scale[:, 0]


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. On the card this
    is cuBLASLt's int8 GEMM, which needs M > 16 and K, N multiples of 8;
    another shape raises rather than running another product."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int8 matmul of ({m}, {k}) by ({k}, {n}) on the card needs more "
                         "than 16 rows and K, N multiples of 8")
    return torch._int_mm(a, b)


def int8_matmul_prequant(x: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor) -> torch.Tensor:
    """(..., K) @ the (N, K) int8 weight with its (N,) scale -> (..., N)
    fp32; the activation is quantized per token here."""
    x_q, x_scale = _quantize(x.float(), -1)
    acc = int_mm(x_q.reshape(-1, x.shape[-1]), w_q.t())
    return acc.float().reshape(*x.shape[:-1], -1) * x_scale * w_scale


def dense(in_features: int, out_features: int, quantize: bool = False, bias: bool = True,
          device=None) -> nn.Linear:
    """An ``nn.Linear``, marked to run int8 when ``quantize``."""
    layer = nn.Linear(in_features, out_features, bias=bias, device=device)
    layer.quantize = quantize
    return layer


def quantized_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` on x through the int8 product, in x's dtype."""
    if getattr(layer, "weight_q", None) is not None:
        y = int8_matmul_prequant(x, layer.weight_q, layer.weight_scale)
    else:
        y = int8_matmul_prequant(x, *quantize_weight(layer.weight))
    y = y.to(x.dtype)
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


@torch.no_grad()
def prequantize_(model: nn.Module) -> nn.Module:
    """Store the int8 payload and scale of every Linear of ``model`` marked
    ``quantize``, from its weight as it is now (buffers outside the state
    dict). Call it again after loading other weights."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear) and getattr(mod, "quantize", False):
            w_q, w_scale = quantize_weight(mod.weight)
            mod.register_buffer("weight_q", w_q, persistent=False)
            mod.register_buffer("weight_scale", w_scale, persistent=False)
    return model
