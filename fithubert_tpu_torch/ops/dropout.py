"""The random draws of one training forward, from explicit generators.

The JAX package draws its dropout masks from flax's ``dropout``,
``specaug`` and ``layerdrop`` RNG streams
(``fithubert_tpu/train/step.py:309-314``). Here a ``DropoutRNG`` owns two
host ``torch.Generator``s: ``host``, seeded from ``seed``, and ``specaug``,
seeded from ``specaug_seed`` (default ``seed``), which a data-parallel step
keeps free of the rank, so every rank draws the global batch's SpecAugment
masks (``ops/specaug.py``).

Every draw that a kernel or a device op reads goes through ``stage``: a
host function of the generators whose tensors are put on the device. Made
when the forward starts, ``table`` holds ``TABLE_SLOTS`` pairs of 32-bit
words drawn from ``host`` in one call; each random site of the forward
takes the next pair (``seed_words``): the attention kernels' and K5's seeds
(``ops/kernels``), elementwise dropout (``dropout``, K5 on the activation,
whose mask its backward regenerates, in the place of ``nn.Dropout``, which
is XLA's RNG and not a kernel there) and the layerdrop gates (``keep``, a
device flag, JAX's ``jnp.where``). SpecAugment's widths and positions are
drawn on the host from ``specaug`` and staged likewise. The card and the
CPU therefore draw the same masks, and the forward makes no host decision
and no host copy of its own, so a CUDA graph can be captured over it: the
graph's ``stage`` records each draw function and the static tensor it
fills, and the host replays the functions on the next step's generators
and writes their results there before each replay (``train/step.py``).

Under a model axis (``parallel/mesh.py``) every rank of a mesh row draws
the same table. A site on a replicated tensor (the encoder input, the
dropout after a row-parallel layer, layerdrop, SpecAugment) takes its
words as they are, so the row's ranks stay equal. A site on a sharded
tensor (a sharded attention's probabilities, the hidden of a sharded FFN)
asks for ``seed_words(sharded=True)``, which XORs a constant times the
``model_rank`` into both words on the device, as JAX's shard_map folds the
shard index into the kernel's seed (``flash_attention.py:465-470``): the
ranks' heads draw apart, and model rank 0 keeps one process's words.

The slots are laid out so that a layer's draws do not depend on what ran
before it: the encoder's own draws (the front end, the encoder input,
layerdrop) take slots ``[0, ENCODER_SLOTS)``, and encoder layer ``i`` takes
``LAYER_SLOTS`` slots of its own (``fork``). An activation-checkpointed
layer replays its draws when it is recomputed, with checkpointing on or
off alike. The same seed replays the same masks; a forward given no
``DropoutRNG`` is deterministic.
"""

from __future__ import annotations

import copy
import types
from typing import Callable, Optional, Tuple, Union

import torch

from fithubert_tpu_torch.ops.kernels.dropout import seeded_dropout
from fithubert_tpu_torch.ops.kernels.philox import M32, keep_bits

# folded into the SpecAugment seed, so its stream is not the host stream's
_SPECAUG_STREAM = 0x5DEECE66D

TABLE_SLOTS = 1024  # seed-word pairs of one forward
ENCODER_SLOTS = 64  # the slots drawn outside the encoder layers
LAYER_SLOTS = 16  # the slots of one encoder layer: a conformer layer takes 7
# folded into a sharded site's words per model rank (JAX's 2654435761 & 0x7FFFFFFF)
_MODEL_FOLD = 2654435761 & 0x7FFFFFFF

Draw = Callable[["DropoutRNG"], Tuple[torch.Tensor, ...]]
Stage = Callable[["DropoutRNG", Draw], Tuple[torch.Tensor, ...]]


def draw_table(gen: torch.Generator) -> torch.Tensor:
    """(TABLE_SLOTS, 2) int32: uniform 32-bit words as their bit patterns."""
    w = torch.randint(0, 2 ** 32, (TABLE_SLOTS, 2), generator=gen, dtype=torch.int64)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def host_streams(seed: int, specaug_seed: Optional[int] = None) -> types.SimpleNamespace:
    """The two host generators of a ``DropoutRNG``: ``host`` and
    ``specaug``, as the forward's draw functions read them."""
    base = seed if specaug_seed is None else specaug_seed
    return types.SimpleNamespace(
        host=torch.Generator().manual_seed(seed),
        specaug=torch.Generator().manual_seed((base ^ _SPECAUG_STREAM) % (1 << 63)))


def to_device(rng: "DropoutRNG", draw: Draw) -> Tuple[torch.Tensor, ...]:
    """The eager ``stage``: the draws on ``rng.device``; to a card from
    pinned memory, without waiting for it."""
    out = draw(rng)
    if rng.device.type != "cuda":
        return tuple(t.to(rng.device) for t in out)
    return tuple(t.pin_memory().to(rng.device, non_blocking=True) for t in out)


class DropoutRNG:
    def __init__(self, seed: int, device: Union[str, torch.device],
                 specaug_seed: Optional[int] = None, stage: Optional[Stage] = None,
                 model_rank: int = 0):
        self.device = torch.device(device)
        self.model_rank = model_rank
        streams = host_streams(seed, specaug_seed)
        self.host, self.specaug = streams.host, streams.specaug
        self._stage = stage or to_device
        (self.table,) = self.stage(lambda r: (draw_table(r.host),))
        self._next, self._end = 0, ENCODER_SLOTS

    def stage(self, draw: Draw) -> Tuple[torch.Tensor, ...]:
        """``draw(self)``, host tensors drawn from ``host`` or ``specaug``,
        on the device."""
        return self._stage(self, draw)

    def fork(self, index: int) -> "DropoutRNG":
        """The draws of encoder layer ``index``: the same table and
        generators, from the layer's own slots. Forking again replays them."""
        child = copy.copy(self)
        child._next = ENCODER_SLOTS + index * LAYER_SLOTS
        child._end = child._next + LAYER_SLOTS
        if child._end > TABLE_SLOTS:
            raise ValueError(f"layer {index}: a forward draws for at most "
                             f"{(TABLE_SLOTS - ENCODER_SLOTS) // LAYER_SLOTS} layers")
        return child

    def seed_words(self, sharded: bool = False) -> torch.Tensor:
        """The next slot: (2,) int32 on the device, the two 32-bit words of
        one kernel's keep mask; ``sharded``: with this model rank folded in."""
        if self._next >= self._end:
            raise RuntimeError("a block of the seed table is used up: a layer draws at most "
                               f"{LAYER_SLOTS} times, the encoder {ENCODER_SLOTS}")
        words = self.table[self._next]
        self._next += 1
        if sharded and self.model_rank:
            words = words ^ ((_MODEL_FOLD * self.model_rank) & 0x7FFFFFFF)
        return words

    def keep(self, p: float) -> torch.Tensor:
        """A 0-d bool on the device, True with probability 1 - p."""
        return keep_bits(self.seed_words()[0].long() & M32, p)

    def dropout(self, x: torch.Tensor, p: float, sharded: bool = False) -> torch.Tensor:
        """Zero each element with probability p, scale the rest by 1/(1-p)."""
        return seeded_dropout(x, self.seed_words(sharded), p)


def dropout(x: torch.Tensor, p: float, rng: Optional[DropoutRNG],
            sharded: bool = False) -> torch.Tensor:
    """``x`` unchanged when deterministic (no rng) or p = 0; ``sharded``: x
    is a model rank's shard (``DropoutRNG.seed_words``)."""
    return x if rng is None or p <= 0.0 else rng.dropout(x, p, sharded)
