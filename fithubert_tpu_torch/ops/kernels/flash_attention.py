"""Attention over (B, T, H, D) with probability dropout and its gradient:
``flash_attention`` and the plain versions ``attention_plain`` and
``attention_bwd_plain``.

Counterpart of ``fithubert_tpu/ops/pallas/flash_attention.py:392
flash_attention``: the forward kernel ``_make_fwd_kernel`` (``:64``, K2),
the backward kernels ``_make_bwd_dq_kernel`` (``:127``, K3) and
``_make_bwd_dkv_kernel`` (``:173``, K4), tied together by ``_flash_core``'s
custom VJP (``:271-357``). q is pre-scaled by the caller;
``key_padding_mask`` is (B, T) with True at padding.

On a CUDA tensor the forward launches ``csrc/flash_attention.cu`` (an fp32
online softmax that also returns the per-row logsumexp (B, H, T); in bf16 on
Hopper's wgmma fed by TMA, one block per tile of ``FWD_QUERY_TILE`` queries
of one (b, h), ``fwd_launch_geometry``, with ``attention_fwd_tiles_plain``
as the plain version of its arithmetic) and the backward
``csrc/flash_attention_bwd.cu``. In bf16 the backward is three
launches: a pre-pass for delta = rowsum(dO * O), one fused pass on Hopper's
wgmma and TMA that writes dK, dV and an fp32 dQ partial per key tile, and a
pass that sums the partials in key-tile order (``BWD_KEY_TILE``,
``dq_scratch_shape``); ``attention_bwd_tiles_plain`` and ``dq_sum_plain``
are the plain versions of the last two. In fp32 the pre-pass is followed by
an FMA body for dQ and one for dK and dV. In bf16 the kernels multiply on
the tensor cores as the TPU kernels do (bf16 operands, fp32 sums, P and dS
rounded to bf16 before their second product; dS enters dQ in two bf16
parts). On a CPU tensor both directions run their plain versions, which
mirror ``_attention_reference`` (``:35-46``) with an fp32 softmax and the
backward formulas of ``:295-357``.

The kernels are compiled for the head sizes ``HEAD_DIMS``; any other D up
to 128 is zero-padded to the next of them and the results cropped
(``padded_attention``, ``padded_attention_bwd``), as XLA pads the TPU
kernel's lane dimension (``:14-17``). That is exact: q is pre-scaled by the
caller, zero columns add nothing to Q K^T, and zero columns of V give zero
output columns, which are dropped. The bf16 kernels read each (b, t, h) row
in 16-byte chunks (``rows_aligned``); operands whose rows are not so
aligned are copied.

The dropout seed is a (2,) int32 tensor on the data's device, which the
kernels read from device memory when they start: a CUDA graph
captured over them draws the masks of whatever words the tensor holds at
each replay (``train/step.py``).

Dropout acts on the unnormalised probabilities while the normaliser keeps
the undropped sum (``:100-106``). The keep mask is a pure function of
(seed word 0, seed word 1, z = b * H + h, query row i, key column j):
Philox-4x32-10 (``philox.py``) on the counter (j >> 2, i, z, 0) under the
key (seed 0, seed 1), word j & 3, kept when its top 24 bits reach floor(p * 2^24) as in
``_keep_mask`` (``:49-60``). Unlike the TPU's per-block streams, this does
not depend on how a kernel tiles, so the forward, the backward kernels and
the plain versions all draw the same mask.

Rows whose keys are all padding differ, as in the JAX package: the kernel
gives out = 0 and lse = -1e30, the plain forward a uniform softmax over the
finite -1e30 logits. Both backwards give exactly zero gradients there.
The backward reads the forward's output O in q's dtype (the TPU kernel
keeps it in fp32), so in bf16 delta = rowsum(dO * O) carries O's rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from fithubert_tpu_torch.ops.kernels import _build
import torch.nn.functional as F

from fithubert_tpu_torch.ops.kernels.philox import (
    Seed,
    check_rate,
    check_seed,
    keep_bits,
    key_words,
    philox4x32,
    pick_word,
    threshold,
)

KERNEL = "flash_attention_fwd_cuda"
KERNEL_DROPOUT = "flash_attention_fwd_dropout_cuda"
# the backward: in bf16 one launch of each of BWD_KERNELS, in fp32 the
# pre-pass and the two FMA bodies
KERNEL_BWD_PREP = "flash_attention_bwd_prep_cuda"
KERNEL_BWD = "flash_attention_bwd_cuda"
KERNEL_DQ_SUM = "flash_attention_bwd_dq_sum_cuda"
KERNEL_DQ_F32 = "flash_attention_bwd_dq_f32_cuda"
KERNEL_DKV_F32 = "flash_attention_bwd_dkv_f32_cuda"
BWD_KERNELS = (KERNEL_BWD_PREP, KERNEL_BWD, KERNEL_DQ_SUM)
# keys per block of the fused backward (one consumer warpgroup) and so per
# dQ partial
BWD_KEY_TILE = 64
# registers a thread that every instantiation of the fused backward must be
# built with, the count its setmaxnreg plan hands out (Fused::LAUNCH_REGS);
# at another the launch is refused (_build.REG_ERROR)
BWD_FUSED_REGS = 128
NEG_INF = -1e30
# head sizes the kernels are compiled for (csrc/flash_attention*.cu
# FA_HEAD_DIMS); others pad to the next one
HEAD_DIMS = (16, 32, 40, 48, 64, 80, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 forward: queries per block (one consumer warpgroup), keys per
# stage of its K / V ring and so per step of its online softmax, and the
# registers a thread its setmaxnreg plan assumes at each head size
# (Fwd::LAUNCH_REGS: three blocks an SM at D <= 64, two above)
FWD_QUERY_TILE = 64
FWD_KEY_TILE = 64
FWD_REGS = {d: 80 if d <= 64 else 128 for d in HEAD_DIMS}


def _check(q, k, v, key_padding_mask, dropout_p, seed) -> None:
    check_rate(dropout_p)
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout needs a seed: a (2,) int32 tensor")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k and v must share one (B, T, H, D) shape")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}")
    if key_padding_mask is not None and (
            key_padding_mask.dtype != torch.bool
            or tuple(key_padding_mask.shape) != (q.shape[0], q.shape[1])):
        raise ValueError("key_padding_mask must be a (B, T) bool tensor")
    for t in (k, v) + (() if key_padding_mask is None else (key_padding_mask,)):
        if t.device != q.device:
            raise ValueError("all inputs must lie on one device")


def keep_mask(b: int, h: int, t: int, dropout_p: float, seed: Seed,
              device=None) -> torch.Tensor:
    """(B, H, T, T) bool: True where a probability is kept."""
    z = torch.arange(b * h, device=device, dtype=torch.int64).view(b, h, 1, 1)
    i = torch.arange(t, device=device, dtype=torch.int64).view(1, 1, t, 1)
    j = torch.arange(t, device=device, dtype=torch.int64).view(1, 1, 1, t)
    words = philox4x32(j >> 2, i, z, torch.zeros_like(j), key_words(seed))
    return keep_bits(pick_word(words, (j & 3).expand(b, h, t, t)), dropout_p)


def _logits(q, k, key_padding_mask):
    """fp32 logits (B, H, T, T) with masked keys at -1e30."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    return logits


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, seed: Optional[Seed] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax attention in fp32, probabilities dropped by
    ``keep_mask``; returns (out in q's dtype, lse)."""
    logits = _logits(q, k, key_padding_mask)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        b, t, h, _d = q.shape
        keep = keep_mask(b, h, t, dropout_p, seed, q.device)
        probs = probs * keep * (1.0 / (1.0 - dropout_p))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    if key_padding_mask is not None:
        lse = lse.masked_fill(key_padding_mask.all(-1)[:, None, None], NEG_INF)
    return out, lse


def fwd_launch_geometry(b: int, t: int, h: int, d: int) -> Tuple[int, int, int]:
    """The bf16 forward's launch at a compiled head size d: (query tiles,
    blocks, dynamic shared-memory bytes). A block takes one query tile of
    one (b, h). Its shared memory holds the Q tile and a ring of K and V
    stages (4 at d <= 64, where three blocks share an SM, 2 above, where
    two do), each in [64 rows][64 columns] boxes of 8 KB, and 1 KB to align
    them."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernels are built for head sizes {HEAD_DIMS}, not {d}")
    n_qt = -(-t // FWD_QUERY_TILE)
    boxes, stages = -(-d // 64), (4 if d <= 64 else 2)
    return n_qt, n_qt * b * h, (1 + 2 * stages) * boxes * 8192 + 1024


def attention_fwd_tiles_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              dropout_p: float = 0.0, seed: Optional[Seed] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward's arithmetic: (out in q's dtype, lse). The online
    softmax runs over tiles of ``FWD_KEY_TILE`` keys in fp32; each tile's P
    = exp(S - m) against the running max m (masked keys at -1e30 in S and 0
    in P), dropped by ``keep_mask`` and scaled, is rounded to q's dtype
    before P V; O is rescaled by alpha = exp(m_old - m); the normaliser l
    and lse = m + log l stay undropped. A row without a valid key gives out
    0 and lse -1e30."""
    b, t, h, _d = q.shape
    dev = q.device
    logits = _logits(q, k, None)
    ok = (torch.ones(b, t, dtype=torch.bool, device=dev) if key_padding_mask is None
          else ~key_padding_mask)[:, None, None, :]
    scale = None
    if dropout_p > 0.0:
        scale = torch.where(keep_mask(b, h, t, dropout_p, seed, dev), 1.0 / (1.0 - dropout_p),
                            0.0)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l_ = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, q.shape[-1]), dtype=torch.float32, device=dev)
    v32 = v.float()
    for j in range(0, t, FWD_KEY_TILE):
        tile = slice(j, j + FWD_KEY_TILE)
        s = logits[..., tile].masked_fill(~ok[..., tile], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).masked_fill(~ok[..., tile], 0.0)
        l_ = l_ * alpha + p.sum(-1)
        pv = p if scale is None else p * scale[..., tile]
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                    pv.to(q.dtype).float(), v32[:, tile])
        m = m_new
    out = torch.where(l_[..., None] > 0, acc / l_[..., None], 0.0)
    lse = torch.where(l_ > 0, m + torch.log(l_), NEG_INF)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def bwd_prep_plain(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, T)."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def _probs_and_ds(q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed):
    """P with masked keys zeroed explicitly, P_dropped and dS, each (B, H,
    T, T) fp32, by the formulas of the backward kernels."""
    logits = _logits(q, k, key_padding_mask)
    p = torch.exp(logits - lse[..., None])
    if key_padding_mask is not None:
        p = p.masked_fill(key_padding_mask[:, None, None, :], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    pv = p
    if dropout_p > 0.0:
        b, t, h, _d = q.shape
        scale = torch.where(keep_mask(b, h, t, dropout_p, seed, q.device),
                            1.0 / (1.0 - dropout_p), 0.0)
        pv, dp = p * scale, dp * scale
    return pv, p * (dp - delta[..., None])


def attention_bwd_plain(q, k, v, key_padding_mask, out, lse, dout,
                        dropout_p: float = 0.0, seed: Optional[Seed] = None):
    """(dq, dk, dv) in q's dtype by the formulas of the backward kernels:
    P = exp(s - lse) with masked keys zeroed explicitly, dV = P_dropped^T dO,
    dS = P * (dP_dropped - rowsum(dO * O)), dQ = dS K, dK = dS^T Q."""
    pv, ds = _probs_and_ds(q, k, v, key_padding_mask, lse, dout, bwd_prep_plain(out, dout),
                           dropout_p, seed)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pv, dout.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def dq_scratch_shape(b: int, t: int, h: int, d: int) -> Tuple[int, ...]:
    """The fp32 dQ partials of the fused backward: one (B, T, H, D) slice per
    tile of ``BWD_KEY_TILE`` keys."""
    return (-(-t // BWD_KEY_TILE), b, t, h, d)


def attention_bwd_tiles_plain(q, k, v, key_padding_mask, lse, dout, delta,
                              dropout_p: float = 0.0, seed: Optional[Seed] = None):
    """The fused backward's arithmetic: (dQ partials ``dq_scratch_shape`` in
    fp32, dK, dV in q's dtype). P_dropped and dS are rounded to q's dtype
    before dV and dK; dS enters dQ as hi + lo, hi = dS and lo = dS - hi each
    rounded to q's dtype; partial i sums keys [i * BWD_KEY_TILE, (i + 1) *
    BWD_KEY_TILE) in fp32."""
    b, t, h, d = q.shape
    pv, ds = _probs_and_ds(q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed)

    def rnd(x):  # an operand as the kernel rounds it
        return x.to(q.dtype).float()

    hi = rnd(ds)
    ds2 = hi + rnd(ds - hi)
    dk = torch.einsum("bhqk,bqhd->bkhd", hi, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", rnd(pv), dout.float())
    k32, n = k.float(), BWD_KEY_TILE
    parts = torch.stack([torch.einsum("bhqk,bkhd->bqhd", ds2[..., j:j + n], k32[:, j:j + n])
                         for j in range(0, t, n)])
    assert parts.shape == dq_scratch_shape(b, t, h, d)
    return parts, dk.to(q.dtype), dv.to(q.dtype)


def dq_sum_plain(parts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dQ = the partials summed in key-tile order in fp32, then rounded."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc.to(dtype)


def padded_head_dim(d: int) -> int:
    """The compiled head size a D pads to: the least of ``HEAD_DIMS`` >= d."""
    for dp in HEAD_DIMS:
        if dp >= d:
            return dp
    raise ValueError(f"head size {d}: the attention kernels take head sizes up to "
                     f"{HEAD_DIMS[-1]}")


def rows_aligned(shape, strides, storage_offset: int, itemsize: int, align: int = 16) -> bool:
    """Whether every (b, t, h) row of a (B, T, H, D) view with unit stride
    along D starts on an ``align``-byte boundary, given that its storage
    does: the storage offset and every stride along a dimension longer than
    1 must be whole multiples of ``align`` bytes."""
    return (storage_offset * itemsize) % align == 0 and all(
        (s * itemsize) % align == 0 for n, s in zip(shape[:3], strides[:3]) if n > 1)


def _readable(x: torch.Tensor) -> bool:
    """Whether the kernels can read x in place: unit stride along D and, in
    bf16, every row on a 16-byte boundary (TMA's maps take strides and a
    base of whole 16-byte units)."""
    return x.stride(-1) == 1 and (x.dtype != torch.bfloat16 or (
        rows_aligned(x.shape, x.stride(), x.storage_offset(), x.element_size())
        and x.untyped_storage().data_ptr() % 16 == 0))


def pad_heads(x: torch.Tensor, dp: int) -> torch.Tensor:
    """x (B, T, H, D) as the kernels read it at head size dp >= D: itself
    where it can be, else a contiguous copy zero-padded along D."""
    d = x.shape[-1]
    if d == dp and _readable(x):
        return x
    return F.pad(x, (0, dp - d)) if dp > d else x.clone(memory_format=torch.contiguous_format)


def padded_attention(fwd, q, k, v, key_padding_mask, dropout_p, seed):
    """``fwd(q, k, v, mask, p, seed) -> (out, lse)`` run at the compiled
    head size ``padded_head_dim(D)``, its output cropped back to D."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    out, lse = fwd(*(pad_heads(x, dp) for x in (q, k, v)), key_padding_mask, dropout_p, seed)
    return (out if dp == d else out[..., :d].contiguous()), lse


def padded_attention_bwd(bwd, q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed):
    """``bwd(q, k, v, mask, lse, dout, delta, p, seed) -> grads`` run at the
    compiled head size, each gradient cropped back to D. ``delta`` =
    rowsum(dO * O) (B, H, T) is the same padded or not."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    qp, kp, vp = (pad_heads(x, dp) for x in (q, k, v))
    dop = dout.contiguous() if dp == d else F.pad(dout, (0, dp - d))
    grads = bwd(qp, kp, vp, key_padding_mask, lse, dop, delta, dropout_p, seed)
    return tuple(g if dp == d else g[..., :d].contiguous() for g in grads)


_SEED_TAIL = [ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
              ctypes.c_void_p]  # thr, inv_keep, seed pointer, stream


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] * 9 + _SEED_TAIL
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_maps_fn():
    fn = _build.load("flash_attention").flash_attention_fwd_maps
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_int]
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load("flash_attention_bwd")
    strided = [ctypes.c_int] * 3 + [ctypes.c_longlong] * 9 + _SEED_TAIL  # B, T, H, strides
    fns = {"prep": lib.flash_attention_bwd_prep, "fused": lib.flash_attention_bwd_fused,
           "dq_sum": lib.flash_attention_bwd_dq_sum, "dq_f32": lib.flash_attention_bwd_dq_f32,
           "dkv_f32": lib.flash_attention_bwd_dkv_f32}
    fns["prep"].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fns["fused"].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + strided
    fns["dq_sum"].argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_void_p]
    fns["dq_f32"].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + strided
    fns["dkv_f32"].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + strided
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_cuda(what: str, *xs: torch.Tensor) -> None:
    if any(x.device.type != "cuda" for x in xs):
        raise ValueError(f"{what} launches a CUDA kernel: it takes CUDA tensors only "
                         "(the plain versions run on the CPU)")


def _cuda_args(q, k, v, key_padding_mask):
    """The mask and the strides of q, k and v, which the kernels read in
    place (``pad_heads`` made them readable at a compiled head size)."""
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernels are built for head sizes {HEAD_DIMS}, not "
                         f"{d} (padded_attention pads to them)")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need unit stride along D")
    if not all(_readable(x) for x in (q, k, v)):
        # the bf16 kernels read q, k and v through TMA maps of 16-byte strides
        raise ValueError("bf16 q, k and v need every (b, t, h) row on a 16-byte boundary "
                         "(pad_heads copies them)")
    if b * h > 65535:
        raise ValueError("B * H must be at most 65535 (one grid row per (b, h))")
    mask = None if key_padding_mask is None else key_padding_mask.contiguous()
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    return mask, strides


def _dropout_args(dropout_p: float, seed: Optional[Seed]):
    if dropout_p <= 0.0:
        return [0, 1.0, None]
    return [threshold(dropout_p), 1.0 / (1.0 - dropout_p), seed.data_ptr()]


def _fwd_kernel(q, k, v, key_padding_mask, dropout_p, seed):
    """K2 on q, k, v at a compiled head size: one launch."""
    _on_cuda("the attention forward", q, k, v)
    b, t, h, d = q.shape
    mask, strides = _cuda_args(q, k, v, key_padding_mask)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _fwd_fn()(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, t, h, *strides, *_dropout_args(dropout_p, seed),
                    _stream(q))
    name = KERNEL_DROPOUT if dropout_p > 0.0 else KERNEL
    _build.check(err, name)
    _build.count_launch(name)
    return out, lse


def fwd_maps_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, reps: int) -> None:
    """Encode the bf16 forward's three TMA maps of q, k and v ``reps``
    times on the host, as each launch does, and launch nothing: the host's
    share of a call, timed by ``chip_smoke.py``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the TMA maps are the bf16 forward's, not {q.dtype}'s")
    _on_cuda("fwd_maps_cuda", q, k, v)
    _mask, strides = _cuda_args(q, k, v, None)
    b, t, h, d = q.shape
    _build.check(_fwd_maps_fn()(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), b, t, h,
                                *strides, reps), "flash_attention_fwd_maps")


def _flash_cuda(q, k, v, key_padding_mask, dropout_p, seed):
    return padded_attention(_fwd_kernel, q, k, v, key_padding_mask, dropout_p, seed)


def bwd_prep_cuda(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The pre-pass: delta = rowsum(dO * O), (B, H, T) fp32, from out and
    dout (B, T, H, D), both contiguous in one dtype, at any D."""
    if out.dim() != 4 or dout.shape != out.shape or dout.dtype != out.dtype \
            or out.dtype not in _DTYPE_CODE:
        raise ValueError("out and dout must be (B, T, H, D) tensors of one float32 or "
                         "bfloat16 dtype")
    if not (out.is_contiguous() and dout.is_contiguous()):
        raise ValueError("out and dout must be contiguous")
    _on_cuda("bwd_prep_cuda", out, dout)
    b, t, h, d = out.shape
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    err = _bwd_fns()["prep"](_DTYPE_CODE[out.dtype], dout.data_ptr(), out.data_ptr(),
                             delta.data_ptr(), b, t, h, d, _stream(out))
    _build.check(err, KERNEL_BWD_PREP)
    _build.count_launch(KERNEL_BWD_PREP)
    return delta


def dq_sum_cuda(parts: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dQ (B, T, H, D) in bf16 from the fp32 partials of the fused backward,
    summed in key-tile order (``dq_sum_plain``)."""
    if parts.dim() != 5 or parts.dtype != torch.float32 or not parts.is_contiguous():
        raise ValueError("parts must be a contiguous (key tiles, B, T, H, D) float32 tensor")
    if dtype != torch.bfloat16 or parts.shape[-1] % 8:
        raise ValueError("the dQ sum writes bf16 rows of a multiple of 8 elements")
    _on_cuda("dq_sum_cuda", parts)
    dq = torch.empty(parts.shape[1:], dtype=dtype, device=parts.device)
    err = _bwd_fns()["dq_sum"](parts.data_ptr(), dq.data_ptr(), dq.numel(), parts.shape[0],
                               _stream(parts))
    _build.check(err, KERNEL_DQ_SUM)
    _build.count_launch(KERNEL_DQ_SUM)
    return dq


def _check_bwd(q, dout, lse, delta) -> None:
    b, t, h, _d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError("dout must be a contiguous (B, T, H, D) tensor in q's dtype")
    if dout.dtype == torch.bfloat16 and dout.data_ptr() % 16 != 0:
        raise ValueError("bf16 dout must start on a 16-byte boundary")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, T) float32 tensor")


def _bwd_head(q, k, v, key_padding_mask, lse, dout, delta):
    """The pointers every backward kernel of q, k, v takes first, and its
    trailing (B, T, H, strides) arguments."""
    _check_bwd(q, dout, lse, delta)
    mask, strides = _cuda_args(q, k, v, key_padding_mask)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr()]
    return ptrs, [q.shape[0], q.shape[1], q.shape[2], *strides]


def bwd_fused_cuda(q, k, v, key_padding_mask, lse, dout, delta, dropout_p=0.0, seed=None):
    """The fused bf16 pass at a compiled head size: (dQ partials
    ``dq_scratch_shape`` fp32, dK, dV)."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the fused backward runs in bfloat16, not {q.dtype}")
    _on_cuda("bwd_fused_cuda", q, k, v, dout, lse, delta)
    ptrs, tail = _bwd_head(q, k, v, key_padding_mask, lse, dout, delta)
    parts = torch.empty(dq_scratch_shape(*q.shape), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    err = _bwd_fns()["fused"](q.shape[3], *ptrs, parts.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), *tail, *_dropout_args(dropout_p, seed), _stream(q))
    _build.check(err, KERNEL_BWD)
    _build.count_launch(KERNEL_BWD)
    return parts, dk, dv


def _bwd_bf16(q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed):
    parts, dk, dv = bwd_fused_cuda(q, k, v, key_padding_mask, lse, dout, delta, dropout_p,
                                   seed)
    return dq_sum_cuda(parts, q.dtype), dk, dv


def _bwd_f32(q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed):
    """The fp32 FMA bodies: dQ, then dK and dV."""
    ptrs, tail = _bwd_head(q, k, v, key_padding_mask, lse, dout, delta)
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
    d, seed_args, stream = q.shape[3], _dropout_args(dropout_p, seed), _stream(q)
    for name, fn, outs in ((KERNEL_DQ_F32, "dq_f32", grads[:1]),
                           (KERNEL_DKV_F32, "dkv_f32", grads[1:])):
        err = _bwd_fns()[fn](d, *ptrs, *(x.data_ptr() for x in outs), *tail, *seed_args,
                             stream)
        _build.check(err, name)
        _build.count_launch(name)
    return tuple(grads)


def _flash_bwd_cuda(q, k, v, key_padding_mask, out, lse, dout, dropout_p, seed):
    """(dq, dk, dv) on the card: the pre-pass, then in bf16 the fused pass
    and the dQ sum, in fp32 the two FMA bodies."""
    _on_cuda("the attention backward", q, k, v, out, lse, dout)
    dout = dout.contiguous()
    delta = bwd_prep_cuda(out.contiguous(), dout)
    bwd = _bwd_bf16 if q.dtype == torch.bfloat16 else _bwd_f32
    return padded_attention_bwd(bwd, q, k, v, key_padding_mask, lse, dout, delta, dropout_p,
                                seed)


def _on_device(fn_cuda, fn_plain, x, *args):
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):  # launch on the tensors' card
            return fn_cuda(*args)
    if x.device.type == "cpu":
        return fn_plain(*args)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {x.device}")


class _FlashAttention(torch.autograd.Function):
    """K2 forward, the fused backward (K3 + K4); saves q, k, v, the mask, O,
    lse and the seed, and regenerates the dropout mask in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, dropout_p, seed):
        out, lse = _on_device(_flash_cuda, attention_plain, q,
                              q, k, v, key_padding_mask, dropout_p, seed)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        ctx.dropout_p, ctx.seed = dropout_p, seed
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _on_device(_flash_bwd_cuda, attention_bwd_plain, q,
                                q, k, v, mask, out, lse, dout, ctx.dropout_p, ctx.seed)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, *,
                    dropout_p: float = 0.0, seed: Optional[Seed] = None,
                    return_lse: bool = False):
    """Softmax attention of pre-scaled q over k, v, all (B, T, H, D), with
    probability dropout ``dropout_p`` drawn from ``seed`` (a (2,) int32
    tensor on q's device holding two 32-bit words, ``philox.seed_tensor``).
    Differentiable in q, k and v.

    Returns (B, T, H, D) in q's dtype, and the fp32 logsumexp (B, H, T) too
    when ``return_lse``. CUDA tensors run the kernels, CPU tensors the plain
    versions."""
    _check(q, k, v, key_padding_mask, dropout_p, seed)
    seed = None if dropout_p == 0.0 else check_seed(seed, q.device)
    out, lse = _FlashAttention.apply(q, k, v, key_padding_mask, float(dropout_p), seed)
    return (out, lse) if return_lse else out
