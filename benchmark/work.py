"""The yardstick's arithmetic: operations and bytes of the port's kernels
at given shapes, the model FLOPs of a step or a forward, and the least time
of a launch against the H100's data-sheet peaks (``peaks.json``).

Frozen copies, rewritten over plain shapes: ``conv_work``, ``prefix_work``,
``attn_work``, ``attn_prep_work``, ``attn_fused_work``,
``attn_dq_sum_work``, ``conv_bwd_work`` and ``bound`` of the port's
``chip_smoke.py``; ``conv_stack_flops``, ``encoder_flops``,
``student_fwd_flops`` and ``kd_step_flops`` of the JAX package's
``bench.py``, with the SplitLinear head's products added to the student
forward (``bench.py`` counts only layer-wise heads). Shapes are tuples and
``el`` the element size in bytes; a mask is given as its count of valid
keys.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

Spec = Sequence[Tuple[int, int, int]]

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS: Dict[str, float] = {k: v for k, v in json.load(_f).items()
                               if isinstance(v, (int, float))}
BF16_PEAK = PEAKS["bf16_flops"]
FP32_PEAK = PEAKS["fp32_flops"]
HBM_BPS = PEAKS["hbm_bytes_per_s"]


def bound(flops: float, bytes_: float, peak: float = BF16_PEAK) -> Tuple[float, str]:
    """(least seconds, which bound): the larger of operations over the peak
    rate and bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak, bytes_ / HBM_BPS
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv_work(x: Tuple[int, int, int], spec: Spec, el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) the conv stack from x (B, T, C) needs: inputs read
    once, output once."""
    b, t, c = x
    flops, bytes_ = 0, b * t * c * el
    for (d, k, s) in spec:
        t_out = (t - k) // s + 1
        flops += 2 * b * t_out * d * k * c
        bytes_ += k * c * d * el
        t, c = t_out, d
    return flops, bytes_ + b * t * c * el


def prefix_work(x: Tuple[int, int, int], el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the GroupNorm + GELU prefix of x (B, T, C): x,
    scale and shift read once, a0 written once; ten operations an element."""
    b, t, c = x
    n = b * t * c
    return 10 * n, (2 * n + 2 * b * c) * el


def conv_bwd_work(a0: Tuple[int, int, int], spec: Spec, el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the conv stack's backward from a0: the recompute,
    dW and da each as large as the forward's products; a0, the weights and
    the output gradient read once, da0 and every dW written once in fp32."""
    flops, _ = conv_work(a0, spec, el)
    b, t, c = a0
    bytes_ = b * t * c * (el + 4)
    for (d, k, s) in spec:
        bytes_ += k * c * d * (el + 4)
        t, c = (t - k) // s + 1, d
    return 3 * flops, bytes_ + b * t * c * el


def attn_work(q: Tuple[int, int, int, int], valid: int, el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the attention forward over ``valid`` keys of q
    (B, T, H, D): QK^T and PV; q, k, v, out read or written once, the mask
    and the fp32 logsumexp."""
    b, t, h, d = q
    n = b * t * h * d
    return 4 * h * d * t * valid, 4 * n * el + b * t + b * h * t * 4


def attn_prep_work(q: Tuple[int, int, int, int], el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the backward's delta pre-pass: dO * O read once,
    delta (B, H, T) fp32 written once."""
    b, t, h, d = q
    n = b * t * h * d
    return 2 * n, 2 * n * el + b * h * t * 4


def attn_fused_work(q: Tuple[int, int, int, int], valid: int, key_tile: int = 64,
                    el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the fused backward pass over ``valid`` keys: 12 D
    per query and key; q, k, v, dO, lse, delta and the mask read once, dK,
    dV and the fp32 dQ partials of its key tiles written once."""
    b, t, h, d = q
    n = b * t * h * d
    n_kt = -(-t // key_tile)
    return 12 * h * d * t * valid, 6 * n * el + b * t + 2 * b * h * t * 4 + n_kt * n * 4


def attn_dq_sum_work(q: Tuple[int, int, int, int], key_tile: int = 64,
                     el: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the dQ sum: the partials of every key tile read
    once and added in fp32, dQ written once."""
    b, t, h, d = q
    n = b * t * h * d
    n_kt = -(-t // key_tile)
    return (n_kt - 1) * n, n_kt * n * 4 + n * el


# ------------------------------------------------------------ model FLOPs
def conv_stack_flops(spec: Spec, t_in: int, b: int = 1, c_in: int = 1) -> Tuple[int, int]:
    """(matmul FLOPs, output frames) of a conv stack over t_in samples."""
    fl, t, c = 0, t_in, c_in
    for (d, k, s) in spec:
        t = (t - k) // s + 1
        fl += 2 * b * t * k * c * d
        c = d
    return fl, t


def encoder_flops(b: int, t: int, c: int, ffn: int, layers: int, pos_k: int, pos_g: int,
                  t_pos: int = None) -> int:
    """Matmul FLOPs of one forward of the positional conv (at the encoder
    input length ``t_pos``) and N transformer layers at length t."""
    pos = 2 * b * (t_pos if t_pos is not None else t) * pos_k * c * (c // pos_g)
    per_layer = 4 * (2 * b * t * c * c) + 2 * (2 * b * t * t * c) + 2 * (2 * b * t * c * ffn)
    return pos + layers * per_layer


def student_fwd_flops(d: Dict, t_wav: int, b: int = 1, live_heads: int = None) -> int:
    """Matmul FLOPs of one student forward over t_wav samples: extractor,
    post-extract projection, encoder, the TR layer and its upsampler, and
    the heads (``live_heads`` layer-wise heads, all when None; the
    SplitLinear head's two products when ``split_head``)."""
    fl, frames = conv_stack_flops(d["conv_feature_layers"], t_wav, b)
    e = d["encoder_embed_dim"]
    fl += 2 * b * frames * d["conv_feature_layers"][-1][0] * e  # post_extract_proj
    tr = d["enable_tr_layer"]
    f = d["tr_reduce_factor"]
    t_enc = frames // f if tr else frames
    fl += encoder_flops(b, t_enc, e, d["encoder_ffn_embed_dim"], d["encoder_layers"],
                        d["conv_pos"], d["conv_pos_groups"], t_pos=frames)
    if tr:
        fl += 2 * b * t_enc * f * e * e  # the TR conv
    if d["layerwise_proj"]:
        n = d["encoder_layers"] if live_heads is None else live_heads
        fl += n * (2 * b * t_enc * f * e * e + 2 * b * frames * e * d["pred_head_final_dim"])
    elif live_heads is None and d.get("pred_layer_id"):
        n_tasks = len(d["pred_layer_id"])
        inter = d.get("pred_head_inter_dim") or e
        fl += 2 * b * frames * e * inter * n_tasks
        fl += 2 * b * frames * n_tasks * inter * d["pred_head_final_dim"]
    return fl


def teacher_fwd_flops(t: Dict, t_wav: int, b: int = 1) -> int:
    """Matmul FLOPs of one teacher forward over t_wav samples."""
    fl, frames = conv_stack_flops(t["conv_feature_layers"], t_wav, b)
    e = t["encoder_embed_dim"]
    fl += 2 * b * frames * t["conv_feature_layers"][-1][0] * e
    return fl + encoder_flops(b, frames, e, t["encoder_ffn_embed_dim"], t["encoder_layers"],
                              t["conv_pos"], t["conv_pos_groups"])


def kd_step_flops(student: Dict, teacher: Dict, lengths: Sequence[int]) -> int:
    """Model FLOPs of one optimizer step over rows of the given unpadded
    lengths: each row's teacher forward, and its student forward with the
    backward at twice that; nothing recomputed is counted."""
    return sum(teacher_fwd_flops(teacher, n) + 3 * student_fwd_flops(student, n)
               for n in lengths)
