"""SpecAugment on padded mel batches (``fithubert_tpu/ops/specaug.py``),
each transform split in two:

  draw   the widths and positions (and the time warp's centres), from a
         host ``torch.Generator`` (``DropoutRNG.specaug``), so the card and
         the CPU draw the same masks;
  apply  tensor arithmetic on the draws.

    draws = draw_spec_augment(gen, cfg, b, t, d)
    spec = apply_spec_augment(spec, draws, cfg)
    spec = spec_augment(gen, spec, cfg)          # the two in one
    spec = staged_spec_augment(rng, spec, cfg)   # drawn from rng.specaug, staged

Semantics of ``_mask_along_axis`` (``specaug.py:21-68``, espnet's
MaskAlongAxis): widths are drawn in [lo, hi) with hi = max(hi, lo + 1);
positions are uniform over [0, max(1, L - the largest width drawn)), one
bound for the whole batch; the adaptive clamps apply to the time axis only;
masked values are 0 or the mean of the whole batch, padded rows included.
The frequency masks come before the time masks, whose mean reads the
frequency-masked batch. The time warp (``:71-103``) resamples [0, c) onto
[0, w) and [c, T) onto [w, T) linearly.

Under data parallelism (``BatchStripe``) the batch is global: every rank
draws the global batch's widths and positions from the same seed, applies
its own rows, and sums the mean's numerator over the ranks.

A training forward takes ``staged_spec_augment``: the draws (this rank's
rows of them) are made on the host and put on the device through the
``DropoutRNG``'s ``stage``, so the apply step copies nothing from the host
and a CUDA graph replays it on the draws staged before each replay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fithubert_tpu_torch.config import SpecAugConfig


class MaskDraw(NamedTuple):
    widths: torch.Tensor  # (B, n, 1) int64
    positions: torch.Tensor  # (B, n, 1) int64


class WarpDraw(NamedTuple):
    center: torch.Tensor  # (B,) int64
    warped: torch.Tensor  # (B,) int64


class SpecAugDraws(NamedTuple):
    warp: Optional[WarpDraw]
    freq: Optional[MaskDraw]
    time: Optional[MaskDraw]


@dataclasses.dataclass(frozen=True)
class BatchStripe:
    """This rank's rows of a global batch: ``rows`` (B_local,) indexes the
    global batch of ``n_rows`` rows, ``sum`` sums a tensor over the ranks."""

    rows: torch.Tensor
    n_rows: int
    sum: Callable[[torch.Tensor], torch.Tensor]


def mask_shape(axis_len: int, width_range: Tuple[int, int], num_mask: int, time_axis: bool,
               adaptive: bool = False, adaptive_number_ratio: float = 0.04,
               adaptive_size_ratio: float = 0.04, max_n_time_masks: int = 20
               ) -> Tuple[int, int, int]:
    """(masks per row, lowest width, highest width + 1) after the adaptive
    clamps and hi = max(hi, lo + 1)."""
    lo, hi = width_range
    n = num_mask
    if adaptive and time_axis:
        if adaptive_number_ratio > 0:
            n = min(int(adaptive_number_ratio * axis_len), max_n_time_masks)
        if adaptive_size_ratio > 0:
            hi = min(hi, int(adaptive_size_ratio * axis_len))
    return n, lo, max(hi, lo + 1)


def draw_mask(gen: torch.Generator, b: int, axis_len: int, n: int, lo: int, hi: int
              ) -> Optional[MaskDraw]:
    """``n`` masks per row of ``b``: widths in [lo, hi), positions
    floor(u * max(1, axis_len - the largest width)) for u uniform in [0, 1)
    in fp32. None when n <= 0."""
    if n <= 0:
        return None
    widths = torch.randint(lo, hi, (b, n, 1), generator=gen)
    bound = torch.tensor(max(1, axis_len - int(widths.max())), dtype=torch.float32)
    u = torch.rand((b, n, 1), generator=gen)
    return MaskDraw(widths, torch.floor(u * bound).long())


def draw_time_warp(gen: torch.Generator, b: int, t: int, window: int) -> Optional[WarpDraw]:
    """Centres in [window, t - window) and warped positions centre + 1 +
    [-window, window), clipped to [1, t - 1]; None when t <= 2 window."""
    if t - window <= window:
        return None
    center = torch.randint(window, t - window, (b,), generator=gen)
    warped = (torch.randint(-window, window, (b,), generator=gen) + center + 1).clamp(1, t - 1)
    return WarpDraw(center, warped)


def draw_spec_augment(gen: torch.Generator, cfg: SpecAugConfig, b: int, t: int, d: int
                      ) -> SpecAugDraws:
    """Every draw of one SpecAugment of a (b, t, d) batch: the time warp's,
    then the frequency masks', then the time masks'."""
    warp = draw_time_warp(gen, b, t, cfg.time_warp_window) if cfg.apply_time_warp else None
    freq = time = None
    if cfg.apply_freq_mask:
        freq = draw_mask(gen, b, d, *mask_shape(d, tuple(cfg.freq_mask_width_range),
                                                cfg.num_freq_mask, False))
    if cfg.apply_time_mask:
        time = draw_mask(gen, b, t, *mask_shape(
            t, tuple(cfg.time_mask_width_range), cfg.num_time_mask, True, cfg.adaptive,
            cfg.adaptive_number_ratio, cfg.adaptive_size_ratio, cfg.max_n_time_masks))
    return SpecAugDraws(warp, freq, time)


def apply_mask(spec: torch.Tensor, draw: MaskDraw, axis: int, value: torch.Tensor
               ) -> torch.Tensor:
    """``value`` wherever a mask of ``draw`` covers ``axis`` (1 = time,
    2 = frequency) of spec (B, T, D)."""
    length = spec.shape[axis]
    aran = torch.arange(length, device=spec.device)[None, None, :]
    pos, width = draw.positions.to(spec.device), draw.widths.to(spec.device)
    mask = ((pos <= aran) & (aran < pos + width)).any(1)  # (B, L)
    mask = mask[:, :, None] if axis == 1 else mask[:, None, :]
    return torch.where(mask, value, spec)


def apply_time_warp(spec: torch.Tensor, draw: WarpDraw) -> torch.Tensor:
    """Row i resampled linearly: output frame p reads source p * c / w
    before w, c + (p - w)(T - c) / (T - w) from w on. The result has the
    dtype of spec times an fp32 weight."""
    b, t, _ = spec.shape
    out_pos = torch.arange(t, device=spec.device, dtype=torch.float32)[None, :]
    c = draw.center.to(spec.device)[:, None].float()
    w = draw.warped.to(spec.device)[:, None].float()
    left = out_pos * (c / w)
    right = c + (out_pos - w) * (t - c) / (t - w)
    src = torch.where(out_pos < w, left, right).clamp(0.0, t - 1.0)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (src - lo)[..., None]
    rows = torch.arange(b, device=spec.device)[:, None]
    return spec[rows, lo] * (1 - frac) + spec[rows, hi] * frac


def _rows(draw, rows: Optional[torch.Tensor]):
    return draw if rows is None else type(draw)(*(x[rows.cpu()] for x in draw))


def _inv_count(n: int) -> float:
    """1 / n rounded to fp32, as the fp32 reciprocal of the count."""
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(n)))


def apply_spec_augment(spec: torch.Tensor, draws: SpecAugDraws, cfg: SpecAugConfig,
                       lengths: Optional[torch.Tensor] = None,
                       stripe: Optional[BatchStripe] = None) -> torch.Tensor:
    """The draws applied to spec (B, T, D): the time warp, the frequency
    masks, the time masks, then frames at or past ``lengths`` zeroed. With
    a ``stripe`` the draws are the global batch's and spec holds its rows."""
    rows = None if stripe is None else stripe.rows

    def fill() -> torch.Tensor:
        if cfg.replace_with_zero:
            return torch.zeros((), dtype=spec.dtype, device=spec.device)
        total, n = spec.float().sum(), spec.numel()
        if stripe is not None:
            total, n = stripe.sum(total), stripe.n_rows * spec[0].numel()
        # jnp.mean's arithmetic: the fp32 sum times the fp32 reciprocal of the count
        return (total * _inv_count(n)).to(spec.dtype)

    if draws.warp is not None:
        spec = apply_time_warp(spec, _rows(draws.warp, rows))
    if draws.freq is not None:
        spec = apply_mask(spec, _rows(draws.freq, rows), 2, fill())
    if draws.time is not None:
        spec = apply_mask(spec, _rows(draws.time, rows), 1, fill())
    if lengths is not None:
        valid = torch.arange(spec.shape[1], device=spec.device)[None, :] < lengths[:, None]
        spec = spec.masked_fill(~valid[..., None], 0.0)
    return spec


def spec_augment(gen: torch.Generator, spec: torch.Tensor, cfg: SpecAugConfig,
                 lengths: Optional[torch.Tensor] = None,
                 stripe: Optional[BatchStripe] = None) -> torch.Tensor:
    """Draw from ``gen`` for the (global) batch, then apply to spec."""
    b = spec.shape[0] if stripe is None else stripe.n_rows
    draws = draw_spec_augment(gen, cfg, b, spec.shape[1], spec.shape[2])
    return apply_spec_augment(spec, draws, cfg, lengths, stripe)


def _present(cfg: SpecAugConfig, t: int, d: int) -> Tuple[bool, bool, bool]:
    """Which of (warp, freq, time) ``draw_spec_augment`` draws at (t, d)."""
    freq_n = mask_shape(d, tuple(cfg.freq_mask_width_range), cfg.num_freq_mask, False)[0]
    time_n = mask_shape(t, tuple(cfg.time_mask_width_range), cfg.num_time_mask, True,
                        cfg.adaptive, cfg.adaptive_number_ratio, cfg.adaptive_size_ratio,
                        cfg.max_n_time_masks)[0]
    return (cfg.apply_time_warp and t - cfg.time_warp_window > cfg.time_warp_window,
            cfg.apply_freq_mask and freq_n > 0, cfg.apply_time_mask and time_n > 0)


def staged_spec_augment(rng, spec: torch.Tensor, cfg: SpecAugConfig,
                        lengths: Optional[torch.Tensor] = None,
                        stripe: Optional[BatchStripe] = None) -> torch.Tensor:
    """``spec_augment`` drawn from ``rng.specaug`` (a ``DropoutRNG``), the
    draws of this rank's rows put on the device by ``rng.stage``."""
    b = spec.shape[0] if stripe is None else stripe.n_rows
    t, d = spec.shape[1], spec.shape[2]
    rows = None if stripe is None else stripe.rows.cpu()

    def draw(r):
        draws = draw_spec_augment(r.specaug, cfg, b, t, d)
        return tuple(v for x in draws if x is not None for v in _rows(x, rows))

    flat = iter(rng.stage(draw))
    kinds = (WarpDraw, MaskDraw, MaskDraw)
    draws = SpecAugDraws(*(kind(next(flat), next(flat)) if on else None
                           for kind, on in zip(kinds, _present(cfg, t, d))))
    local = None if stripe is None else dataclasses.replace(stripe, rows=None)
    return apply_spec_augment(spec, draws, cfg, lengths, local)
