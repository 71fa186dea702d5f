"""The launches of one train step or one served call at the cell's
shapes, each with the operations and bytes its work needs
(``work.py``), grouped by kernel family: what the roofline metrics hold
the measured kernel time against. A unit is the rows' unpadded lengths
and the padded length they run at. ``step_launches`` and
``call_launches`` are the fairseq transformer family's lists, which
``reference/model.py`` gives; ``roofline_pct`` takes the lists of the
configuration's reference module (``reference.load``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import reference, work

Launch = Tuple[str, str, int, int]  # family, what, flops, bytes


def _frames(n: int, layers) -> int:
    for (_d, k, s) in layers:
        n = (n - k) // s + 1
    return max(n, 0)


def student_attention(d: Dict, lengths: Sequence[int], t_pad: int) -> Tuple[int, int]:
    """(frames a row enters the attention with, valid keys over the batch)."""
    layers = d["conv_feature_layers"]
    t = _frames(t_pad, layers)
    valid = [min(t, _frames(n, layers)) for n in lengths]
    if d["enable_tr_layer"]:
        f = d["tr_reduce_factor"]
        t = t // f
        valid = [min(t, v // f) for v in valid]
    mult = d.get("required_seq_len_multiple", 1)
    if mult > 1:
        t = -(-t // mult) * mult
    return t, sum(valid)


def teacher_attention(g: Dict, lengths: Sequence[int], t_pad: int) -> Tuple[int, int]:
    """HuBERT: a frame is padding when every sample of its chunk is."""
    t = _frames(t_pad, g["conv_feature_layers"])
    chunk = (t_pad - t_pad % t) // t
    return t, sum(min(t, -(-n // chunk)) for n in lengths)


def _heads(rows: int, t: int, m: Dict) -> Tuple[int, int, int, int]:
    """(B, T, H, D) of a model's attention."""
    h = m["encoder_attention_heads"]
    return rows, t, h, m["encoder_embed_dim"] // h


def _stack(layers, rows: int, t_pad: int) -> Tuple[Tuple[int, int, int], list]:
    d0, k0, s0 = layers[0]
    return (rows, (t_pad - k0) // s0 + 1, d0), [tuple(x) for x in layers[1:]]


def step_launches(cfg: Dict, lengths: Sequence[int], t_pad: int) -> List[Launch]:
    """One optimizer step: the teacher's forward, the student's forward
    and backward (dropout on, so the backward's three passes a layer)."""
    d = cfg["experiment"]["distiller"]
    g = cfg["teacher_geometry"]
    rows = len(lengths)
    out: List[Launch] = []
    stacks = (("student", d["conv_feature_layers"]), ("teacher", g["conv_feature_layers"]))
    for who, layers in stacks:
        a0, spec = _stack(layers, rows, t_pad)
        out.append(("conv", f"{who} prefix", *work.prefix_work(a0)))
        out.append(("conv", f"{who} K1", *work.conv_work(a0, spec)))
        if who == "student":
            out.append(("conv", "student K6", *work.conv_bwd_work(a0, spec)))
    t, valid = student_attention(d, lengths, t_pad)
    q = _heads(rows, t, d)
    for _ in range(d["encoder_layers"]):
        out.append(("attention", "student K2", *work.attn_work(q, valid)))
        out.append(("attention", "student bwd prep", *work.attn_prep_work(q)))
        out.append(("attention", "student bwd fused", *work.attn_fused_work(q, valid)))
        out.append(("attention", "student bwd dQ sum", *work.attn_dq_sum_work(q)))
    t, valid = teacher_attention(g, lengths, t_pad)
    q = _heads(rows, t, g)
    out += [("attention", "teacher K2", *work.attn_work(q, valid))] * g["encoder_layers"]
    return out


def call_launches(cfg: Dict, lengths: Sequence[int], t_pad: int) -> List[Launch]:
    """One served call: the student's forward."""
    d = cfg["experiment"]["distiller"]
    a0, spec = _stack(d["conv_feature_layers"], len(lengths), t_pad)
    out: List[Launch] = [("conv", "prefix", *work.prefix_work(a0)),
                         ("conv", "K1", *work.conv_work(a0, spec))]
    t, valid = student_attention(d, lengths, t_pad)
    q = _heads(len(lengths), t, d)
    out += [("attention", "K2", *work.attn_work(q, valid))] * d["encoder_layers"]
    return out


def least_seconds(launches: Sequence[Launch], family: str) -> float:
    """The family's launches' least times, summed (the prefix at the
    fp32 rate, as its operations are fp32)."""
    total = 0.0
    for fam, what, flops, bytes_ in launches:
        if fam == family:
            peak = work.FP32_PEAK if what.endswith("prefix") else work.BF16_PEAK
            total += work.bound(flops, bytes_, peak)[0]
    return total


def roofline_pct(r, family: str):
    """A family's share of its roofline in a traced run's ``Reading``: the
    least time of its launches at the stretch's shapes, summed, over their
    measured device time, summed; None where the stretch ran none."""
    measured = sum(k.end - k.start for k in r.stretch.family(family)) / 1e9
    if measured <= 0:
        return None
    model = reference.load(r.cell.config)
    per_unit = model.step_launches if r.kind == "train" else model.call_launches
    least = sum(least_seconds(per_unit(r.cell.config, u["lengths"], u["t_pad"]), family)
                for u in r.units)
    return 100.0 * least / measured
