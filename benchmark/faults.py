"""Faults planted in the program's objects under the timed path, for the
tests and the control runs that show ``correct`` comes out false:

    unchanged     a train step that returns the student's state unchanged;
    half_batch    a train step over the first half of its microbatches,
                  its means taken over them;
    altered       a served call whose answer for one utterance is another's.

and, on the card only, in the replay of a captured K-step graph
(``Distiller._replay``), which the CPU never reaches:

    stale_batches a replay that runs on the batches it was captured with,
                  the new ones never copied in;
    frozen_draws  replays after the first that keep its host draws (the
                  dropout seed tables), never staged again.
"""

from __future__ import annotations

import torch


def unchanged(d) -> None:
    step = d._step

    def fault(inputs, make_rng):
        saved = [p.detach().clone() for p in d.params]
        out = step(inputs, make_rng)
        with torch.no_grad():
            for p, s in zip(d.params, saved):
                p.copy_(s)
        return out

    d._step = fault


def half_batch(d) -> None:
    step = d._step

    def fault(inputs, make_rng):
        x, mask, *rest = inputs
        half = max(1, x.shape[0] // 2)
        return step((x[:half], mask[:half], *rest), make_rng)

    d._step = fault


def altered(expert) -> None:
    forward = expert.forward

    def fault(wavs):
        out = forward(wavs)
        h = out["last_hidden_state"]
        out["last_hidden_state"] = torch.cat([h[1:2], h[0:1], h[2:]])
        return out

    expert.forward = fault


def stale_batches(d) -> None:
    replay = d._replay
    d._replay = lambda chain, inputs: replay(chain, chain.inputs)


def frozen_draws(d) -> None:
    replay = d._replay

    def fault(chain, inputs):
        out = replay(chain, inputs)
        chain.staged.entries.clear()  # nothing left to stage on later replays
        return out

    d._replay = fault


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
REPLAY = {"stale_batches": stale_batches, "frozen_draws": frozen_draws}
