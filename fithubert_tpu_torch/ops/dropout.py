"""The random draws of one training forward, from explicit generators.

The JAX package draws its dropout masks from flax's ``dropout``,
``specaug`` and ``layerdrop`` RNG streams
(``fithubert_tpu/train/step.py:309-314``). Here a ``DropoutRNG`` owns three
``torch.Generator``s: one on the tensors' device for elementwise dropout
masks (``bernoulli_``, the counterpart of ``nn.Dropout``, which is XLA's
RNG and not a kernel there), one on the CPU for the per-call
attention-dropout seeds and the layerdrop draws, and ``specaug``, on the
CPU, for SpecAugment's widths and positions (``ops/specaug.py``), so the
card and the CPU draw the same masks. The first two are seeded from
``seed``, the third from ``specaug_seed`` (default ``seed``), which a
data-parallel step keeps free of the rank: every rank draws the global
batch's masks. The same seed replays the same masks on the same device. A
forward given no ``DropoutRNG`` is deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


# folded into the SpecAugment seed, so its stream is not the host stream's
_SPECAUG_STREAM = 0x5DEECE66D


class DropoutRNG:
    def __init__(self, seed: int, device: Union[str, torch.device],
                 specaug_seed: Optional[int] = None):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.device_gen = (torch.Generator(device=device).manual_seed(seed)
                           if device.type == "cuda" else self.host)
        base = seed if specaug_seed is None else specaug_seed
        self.specaug = torch.Generator().manual_seed((base ^ _SPECAUG_STREAM) % (1 << 63))

    def seed_words(self) -> Tuple[int, int]:
        """Two 32-bit words for one attention call's keep mask."""
        w = torch.randint(0, 2 ** 32, (2,), generator=self.host)
        return int(w[0]), int(w[1])

    def uniform(self) -> float:
        return float(torch.rand((), generator=self.host))

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """Zero each element with probability p, scale the rest by 1/(1-p)."""
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=self.device_gen)
        return x * keep / (1.0 - p)


def dropout(x: torch.Tensor, p: float, rng: Optional[DropoutRNG]) -> torch.Tensor:
    """``x`` unchanged when deterministic (no rng) or p = 0."""
    return x if rng is None or p <= 0.0 else rng.dropout(x, p)
