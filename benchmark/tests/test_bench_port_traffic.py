"""The traffic generator: one seed gives one pool, another seed another
order of the same lengths, and the mixture keeps LibriSpeech's mean."""

import numpy as np
import torch

from benchmark import traffic, weights

MIX = traffic.load_mix("librispeech_960")


def test_same_seed_same_traffic_other_seed_other_order():
    seed = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are
    a = traffic.pool_groups(MIX, 16, 32, seed)
    assert a == traffic.pool_groups(MIX, 16, 32, seed)
    b = traffic.pool_groups(MIX, 16, 32, seed + 1)
    assert a != b and sorted(sum(a, [])) == sorted(sum(b, []))
    # every call of 32 pads to 17 s and carries nearly the same audio
    assert {traffic.quantize_length(max(g), 16000) for g in a + b} == {272000}
    sums = [sum(g) for g in a]
    assert (max(sums) - min(sums)) / np.mean(sums) < 0.02
    a = sum(a, [])[:4]

    def audio(s):
        return weights.waveforms(a, max(a), 0.1, weights.generator(s, "audio", "cpu"), "cpu")

    wa, ma = audio(seed)
    wb, mb = audio(seed)
    assert torch.equal(wa, wb) and torch.equal(ma, mb)
    wc, _ = audio(seed + 1)
    assert not torch.equal(wa, wc)
    assert bool((wa[ma] == 0).all())  # nothing past a row's length


def test_mixture_mean_and_range():
    assert abs(traffic.mixture_mean(MIX) - 12.3) < 1e-9
    lengths = np.array(sum(traffic.pool_groups(MIX, 128, 32, 7), [])) / MIX["sample_rate"]
    assert abs(lengths.mean() - 12.3) < 0.01
    assert 1.0 <= lengths.min() and lengths.max() <= 17.0
    assert abs((lengths > 10.0).mean() - 0.85) < 0.01


def test_quantize_length_is_the_loops():
    assert traffic.quantize_length(150000, 40960, 192000) == 163840
    assert traffic.quantize_length(170000, 40960, 192000) == 192000
    assert traffic.quantize_length(255000, 16000) == 256000
    assert traffic.quantize_length(10, 16000) == 16000
