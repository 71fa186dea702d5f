"""The attention family's share of its roofline (``shapes.roofline_pct``):
K2 and, in training, the backward's pre-pass, fused pass and dQ sum."""

from benchmark import shapes


def read(r):
    return shapes.roofline_pct(r, "attention")
