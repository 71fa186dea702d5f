"""The teacher (fairseq HuBERT-Base), the students (FitHuBERT,
DistilHuBERT) and their forwards in plain fp32 PyTorch, over a flat dict
of parameters named as the program's state dicts name them.

Every product and convolution reads its operands through ``q``: the
identity for the reference, a rounding to a lower precision for its
control (``fp8``). The models follow fairseq's code: a conv feature
extractor (GroupNorm on block 0, exact GELU), LayerNorm, the post-extract
projection, a weight-normed grouped positional convolution (same padding,
exact GELU), post-LN transformer layers with dropout after attention and
after the FFN and on the FFN's activation, the students' heads.

The configurations that name no ``reference`` use this module; it meets
the contract of ``reference/__init__.py`` with the FLOP counts of
``work.py`` and the launch lists of ``shapes.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..shapes import call_launches, step_launches  # noqa: F401 (the contract's)
from ..work import kd_step_flops, student_fwd_flops  # noqa: F401 (the contract's)
from . import Spec
from .dropout import Drops, keep_attention

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 type under a per-tensor scale that puts its
    largest magnitude at the type's largest, back in fp32."""
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _FP8(torch.autograd.Function):
    """Operands rounded to e4m3 going forward and their gradients to e5m2
    going back, each tensor under a scale of its own: the float8 recipe of
    training on the H100."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's precision (float8, ``_FP8``)."""
    return _FP8.apply(x)


QUANT = {"fp32": identity, "fp8": fp8}


# ------------------------------------------------------------ parameters
def _extractor_spec(prefix: str, layers) -> Spec:
    out, c_in = [], 1
    for i, (d, k, _s) in enumerate(layers):
        out.append((f"{prefix}conv_layers.{i}.0.weight", (d, c_in, k), "normal",
                    math.sqrt(2.0 / (c_in * k))))
        c_in = d
    d0 = layers[0][0]
    out += [(f"{prefix}conv_layers.0.2.weight", (d0,), "fill", 1.0),
            (f"{prefix}conv_layers.0.2.bias", (d0,), "fill", 0.0)]
    return out


def _norm(key: str, d: int) -> Spec:
    return [(f"{key}.weight", (d,), "fill", 1.0), (f"{key}.bias", (d,), "fill", 0.0)]


def _linear(key: str, d_in: int, d_out: int, std: float) -> Spec:
    return [(f"{key}.weight", (d_out, d_in), "normal", std), (f"{key}.bias", (d_out,), "fill", 0.0)]


def _encoder_spec(e: int, ffn: int, n_layers: int, conv_pos: int, groups: int,
                  tr_slot: int = -1, tr_factor: int = 2) -> Spec:
    std = math.sqrt(4.0 / (conv_pos * e))
    g = std * math.sqrt(e * e / groups)
    out = [("encoder.pos_conv.0.weight_g", (1, 1, conv_pos), "fill", g),
           ("encoder.pos_conv.0.weight_v", (e, e // groups, conv_pos), "normal", std),
           ("encoder.pos_conv.0.bias", (e,), "fill", 0.0)]
    out += _norm("encoder.layer_norm", e)
    n_slots = n_layers + (1 if tr_slot >= 0 else 0)
    for slot in range(n_slots):
        pre = f"encoder.layers.{slot}"
        if slot == tr_slot:  # conv1d, kernel = stride = factor; torch's conv init
            bound = 1.0 / math.sqrt(e * tr_factor)
            out += [(f"{pre}.weight", (e, e, tr_factor), "uniform", bound),
                    (f"{pre}.bias", (e,), "uniform", bound)]
            continue
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _linear(f"{pre}.self_attn.{name}", e, e, 0.02)
        out += _norm(f"{pre}.self_attn_layer_norm", e)
        out += _linear(f"{pre}.fc1", e, ffn, 0.02) + _linear(f"{pre}.fc2", ffn, e, 0.02)
        out += _norm(f"{pre}.final_layer_norm", e)
    return out


def teacher_spec(g: Dict) -> Spec:
    c = g["conv_feature_layers"][-1][0]
    e = g["encoder_embed_dim"]
    proj = _linear("post_extract_proj", c, e, c ** -0.5) if c != e else []
    return (_extractor_spec("feature_extractor.", g["conv_feature_layers"]) + _norm("layer_norm", c)
            + proj + _encoder_spec(e, g["encoder_ffn_embed_dim"], g["encoder_layers"],
                                   g["conv_pos"], g["conv_pos_groups"]))


def student_spec(d: Dict, export: bool = False) -> Spec:
    """The student's parameters; ``export``: the served model's (the
    last layer-wise head alone, or no SplitLinear head)."""
    c = d["conv_feature_layers"][-1][0]
    e = d["encoder_embed_dim"]
    tr = d["enable_tr_layer"]
    f = d["tr_reduce_factor"]
    out = _extractor_spec("feature_extractor.", d["conv_feature_layers"]) + _norm("layer_norm", c)
    if c != e:
        out += _linear("post_extract_proj", c, e, c ** -0.5)
    out += _encoder_spec(e, d["encoder_ffn_embed_dim"], d["encoder_layers"], d["conv_pos"],
                         d["conv_pos_groups"], d["tr_layer_index"] if tr else -1, f)
    final = d["pred_head_final_dim"]
    if d["layerwise_proj"]:
        heads = [d["encoder_layers"] - 1] if export else range(d["encoder_layers"])
        for i in heads:
            if tr:
                bound = 1.0 / math.sqrt(e * f)
                out += [(f"proj_head.{i}.upsampler.weight", (e, e, f), "uniform", bound),
                        (f"proj_head.{i}.upsampler.bias", (e,), "uniform", bound)]
            if e != final:
                out += _linear(f"proj_head.{i}.lin_proj", e, final, e ** -0.5)
    elif not export:
        if tr:
            bound = 1.0 / math.sqrt(e * f)
            out += [("upsampler.weight", (e, e, f), "uniform", bound),
                    ("upsampler.bias", (e,), "uniform", bound)]
        n = len(d["pred_layer_id"])
        inter = d["pred_head_inter_dim"] or e
        out += _linear("proj_head.0", e, inter * n, e ** -0.5)
        bound = inter ** -0.5
        out += [("proj_head.2.weight", (n, inter, final), "uniform", bound),
                ("proj_head.2.bias", (1, 1, n, final), "uniform", bound)]
    return out


# ------------------------------------------------------------ forwards
def _mm(x, w, b, q: Quant):
    return F.linear(q(x), q(w), b)


def extractor(P: Params, layers, wav: torch.Tensor, q: Quant) -> torch.Tensor:
    """(B, T_wav) -> (B, T', C): conv, GroupNorm(C, C) on block 0, GELU."""
    x = wav[:, None, :]
    for i, (d, _k, s) in enumerate(layers):
        x = F.conv1d(q(x), q(P[f"feature_extractor.conv_layers.{i}.0.weight"]), stride=s)
        if i == 0:
            x = F.group_norm(x, d, P["feature_extractor.conv_layers.0.2.weight"],
                             P["feature_extractor.conv_layers.0.2.bias"], 1e-5)
        x = F.gelu(x)
    return x.transpose(1, 2)


def layer_norm(P: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f"{key}.weight"], P[f"{key}.bias"], 1e-5)


def conv_out_lengths(lengths: torch.Tensor, layers) -> torch.Tensor:
    for (_d, k, s) in layers:
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


def pos_conv(P: Params, x: torch.Tensor, k: int, groups: int, q: Quant) -> torch.Tensor:
    v, g = P["encoder.pos_conv.0.weight_v"], P["encoder.pos_conv.0.weight_g"]
    w = g * v / v.norm(dim=(0, 1), keepdim=True)
    y = F.conv1d(q(x.transpose(1, 2)), q(w), P["encoder.pos_conv.0.bias"], padding=k // 2,
                 groups=groups)
    if k % 2 == 0:
        y = y[:, :, :-1]
    return F.gelu(y).transpose(1, 2)


def attention(P: Params, pre: str, x: torch.Tensor, mask: Optional[torch.Tensor], heads: int,
              p: float, drops: Optional[Drops], q: Quant) -> torch.Tensor:
    b, t, c = x.shape
    d = c // heads
    qh = (_mm(x, P[f"{pre}.q_proj.weight"], P[f"{pre}.q_proj.bias"], q) * d ** -0.5)
    kh = _mm(x, P[f"{pre}.k_proj.weight"], P[f"{pre}.k_proj.bias"], q)
    vh = _mm(x, P[f"{pre}.v_proj.weight"], P[f"{pre}.v_proj.bias"], q)
    qh, kh, vh = (z.view(b, t, heads, d) for z in (qh, kh, vh))
    logits = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh))
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if drops is not None and p > 0.0:
        probs = probs * keep_attention(b, heads, t, p, drops.take(), x.device) * (1.0 / (1.0 - p))
    out = torch.einsum("bhqk,bkhd->bqhd", q(probs), q(vh)).reshape(b, t, c)
    return _mm(out, P[f"{pre}.out_proj.weight"], P[f"{pre}.out_proj.bias"], q)


def transformer_layer(P: Params, pre: str, x: torch.Tensor, mask, heads: int, cfg: Dict,
                      drops: Optional[Drops], q: Quant) -> torch.Tensor:
    """A post-LN layer (layer_norm_first: false) in training or in eval."""
    p = cfg.get("dropout", 0.0) if drops is not None else 0.0
    drop = drops.dropout if drops is not None else (lambda z, _p: z)
    y = attention(P, f"{pre}.self_attn", x, mask, heads, cfg.get("attention_dropout", 0.0),
                  drops, q)
    x = layer_norm(P, f"{pre}.self_attn_layer_norm", x + drop(y, p))
    h = F.gelu(_mm(x, P[f"{pre}.fc1.weight"], P[f"{pre}.fc1.bias"], q))
    h = drop(h, cfg.get("activation_dropout", 0.0))
    y = _mm(h, P[f"{pre}.fc2.weight"], P[f"{pre}.fc2.bias"], q)
    return layer_norm(P, f"{pre}.final_layer_norm", x + drop(y, p))


def encoder(P: Params, cfg: Dict, x: torch.Tensor, mask: torch.Tensor,
            drops: Optional[Drops], q: Quant):
    """(x, layer hiddens, frame mask) of the encoder; ``cfg`` holds the
    widths, the TR layer and the dropout rates (0 for a teacher)."""
    if cfg.get("layer_norm_first"):
        raise NotImplementedError("the reference has the post-LN encoder only")
    x = x.masked_fill(mask[..., None], 0.0)
    x = x + pos_conv(P, x, cfg["conv_pos"], cfg["conv_pos_groups"], q)
    x = layer_norm(P, "encoder.layer_norm", x)
    mult = cfg.get("required_seq_len_multiple", 1)
    pad = -x.shape[1] % mult if mult > 1 else 0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad), value=True)
    if drops is not None:
        x = drops.dropout(x, cfg.get("dropout", 0.0))
    tr = cfg.get("enable_tr_layer", False)
    tr_slot = cfg["tr_layer_index"] if tr else -1
    f = cfg.get("tr_reduce_factor", 2)
    hiddens = []
    for slot in range(cfg["encoder_layers"] + (1 if tr else 0)):
        pre = f"encoder.layers.{slot}"
        if slot == tr_slot:
            if cfg["tr_layer_type"] != "conv1d":
                raise NotImplementedError("the reference's TR layer is conv1d")
            x = F.conv1d(q(x.transpose(1, 2)), q(P[f"{pre}.weight"]), P[f"{pre}.bias"],
                         stride=f).transpose(1, 2)
            t = x.shape[1]
            mask = mask[:, : t * f].reshape(mask.shape[0], t, f).any(-1)
            continue
        x = transformer_layer(P, pre, x, mask, cfg["encoder_attention_heads"], cfg,
                              None if drops is None else drops.layer(slot), q)
        hiddens.append(x)
    if pad and not tr:
        x, mask = x[:, :-pad], mask[:, :-pad]
        hiddens = [h[:, :-pad] for h in hiddens]
    return x, hiddens, mask


def teacher_forward(P: Params, g: Dict, wav: torch.Tensor, wav_mask: torch.Tensor,
                    q: Quant = identity):
    """(layer hiddens, frame mask) of a HuBERT teacher: a frame is padding
    when all its samples are (fairseq's forward_padding_mask)."""
    feats = layer_norm(P, "layer_norm", extractor(P, g["conv_feature_layers"], wav, q))
    t = feats.shape[1]
    m = wav_mask[:, : wav_mask.shape[1] - wav_mask.shape[1] % t]
    mask = m.reshape(m.shape[0], t, -1).all(-1)
    if "post_extract_proj.weight" in P:
        feats = _mm(feats, P["post_extract_proj.weight"], P["post_extract_proj.bias"], q)
    _x, hiddens, mask = encoder(P, g, feats, mask, None, q)
    return hiddens, mask


def student_forward(P: Params, d: Dict, wav: torch.Tensor, wav_mask: torch.Tensor,
                    drops: Optional[Drops] = None, q: Quant = identity, export: bool = False):
    """The student's forward: a dict of ``x`` (the served output),
    ``hiddens`` (each transformer layer's output), ``mask`` (frames) and,
    unless ``export``, ``projections`` (B, N, T, D_final)."""
    layers = d["conv_feature_layers"]
    feats = layer_norm(P, "layer_norm", extractor(P, layers, wav, q))
    lengths = conv_out_lengths((~wav_mask).sum(-1), layers)
    mask = torch.arange(feats.shape[1], device=wav.device)[None, :] >= lengths[:, None]
    if "post_extract_proj.weight" in P:
        feats = _mm(feats, P["post_extract_proj.weight"], P["post_extract_proj.bias"], q)
    if drops is not None:
        feats = drops.dropout(feats, d.get("dropout_input", 0.0))
    x, hiddens, mask = encoder(P, d, feats, mask, drops, q)
    out = {"hiddens": hiddens, "mask": mask}
    f = d["tr_reduce_factor"]

    def upsample(h, key):
        return F.conv_transpose1d(q(h.transpose(1, 2)), q(P[f"{key}.weight"]), P[f"{key}.bias"],
                                  stride=f).transpose(1, 2)

    def layerwise(i, h):
        if d["enable_tr_layer"]:
            h = upsample(h, f"proj_head.{i}.upsampler")
        if f"proj_head.{i}.lin_proj.weight" in P:
            h = _mm(h, P[f"proj_head.{i}.lin_proj.weight"], P[f"proj_head.{i}.lin_proj.bias"], q)
        return h

    if d["layerwise_proj"]:
        if export:
            out["x"] = layerwise(d["encoder_layers"] - 1, x)
        else:
            out["projections"] = torch.stack([layerwise(i, h) for i, h in enumerate(hiddens)], 1)
            out["x"] = out["projections"][:, -1]
        return out
    if d["enable_tr_layer"] and not export:
        x = upsample(x, "upsampler")
    out["x"] = x
    if not export:
        b, t, _ = x.shape
        n = len(d["pred_layer_id"])
        h = F.gelu(_mm(x, P["proj_head.0.weight"], P["proj_head.0.bias"], q))
        h = h.view(b, t, n, -1)
        y = torch.einsum("btni,nio->btno", q(h), q(P["proj_head.2.weight"])) + P["proj_head.2.bias"]
        out["projections"] = y.transpose(1, 2)
    return out


def kd_loss(loss: Dict, d: Dict, proj: torch.Tensor, teacher_hiddens: Sequence[torch.Tensor],
            rand_layers: Optional[Sequence[int]]) -> torch.Tensor:
    """The KD loss: the rec term (MSE or L1) and the -logsigmoid cosine
    term over the distilled layers, means over every position, padding
    included; in random-layer mode the drawn layers weigh
    ``random_layer_weight`` and the last layer 1."""
    t_stack = torch.stack(list(teacher_hiddens), 1)
    if loss["distil_random_layer"] > 0:
        ids = list(rand_layers)
        target = torch.cat([t_stack[:, ids], t_stack[:, -1:]], 1)
        pred = torch.cat([proj[:, ids], proj[:, -1:]], 1)
        w = torch.tensor([float(loss["random_layer_weight"])] * len(ids) + [1.0],
                         device=proj.device)
    else:
        ids = list(d["pred_layer_id"])
        target = t_stack[:, ids]
        pred = proj[:, ids] if d["layerwise_proj"] else proj
        w = None
    t_s = min(pred.shape[2], target.shape[2])
    pred, target = pred[:, :, :t_s], target[:, :, :t_s]
    total = torch.zeros((), device=proj.device)

    def reduce(elt):  # (B, N, ...) -> scalar
        per_layer = elt.transpose(0, 1).reshape(elt.shape[1], -1).mean(-1)
        return (per_layer * w).sum() if w is not None else per_layer.mean()

    if loss["rec_loss_weight"] > 0:
        elt = (pred - target).abs() if loss["rec_loss_type"] == "l1" else (pred - target) ** 2
        total = total + loss["rec_loss_weight"] * reduce(elt)
    if loss["sim_loss_weight"] > 0:
        cos = (pred * target).sum(-1) / (pred.norm(dim=-1) * target.norm(dim=-1)).clamp_min(1e-8)
        total = total + loss["sim_loss_weight"] * reduce(-F.logsigmoid(cos))
    return total
