"""The conv family's share of its roofline (``shapes.roofline_pct``): K1,
its prefix and, in training, K6."""

from benchmark import shapes


def read(r):
    return shapes.roofline_pct(r, "conv")
