"""The random draws of one training forward, from explicit generators.

The JAX package draws its dropout masks from flax's ``dropout`` and
``layerdrop`` RNG streams (``fithubert_tpu/train/step.py:309-314``). Here a
``DropoutRNG`` owns two ``torch.Generator``s seeded from one integer: one on
the tensors' device for elementwise dropout masks (``bernoulli_``, the
counterpart of ``nn.Dropout``, which is XLA's RNG and not a kernel there),
and one on the CPU for the per-call attention-dropout seeds and the
layerdrop draws. The same seed replays the same masks on the same device.
A forward given no ``DropoutRNG`` is deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


class DropoutRNG:
    def __init__(self, seed: int, device: Union[str, torch.device]):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.device_gen = (torch.Generator(device=device).manual_seed(seed)
                           if device.type == "cuda" else self.host)

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
