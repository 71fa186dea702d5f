"""wav2vec 2.0 Conformer (fairseq S2T, arXiv:2010.05171; the released
"Conformer Large, rel_pos, LV-60", ``facebook/wav2vec2-conformer-rel-pos-large``)
served as an upstream, in plain fp32 PyTorch over a flat dict of parameters
named as fairseq's state dict names them (the program's keys too).

The served forward follows fairseq's ``Wav2Vec2Model.extract_features``
(``features_only``, no masking) into its ``ConformerEncoder``:

  extractor      ``extractor_mode: layer_norm``: each block a strided conv
                 with bias, a LayerNorm over channels, the exact GELU
  features       LayerNorm, the frame padding mask from the conv length
                 formula, ``crop_seq_to_multiple``, ``post_extract_proj``,
                 padded frames zeroed
  positions      espnet's ``RelPositionalEncoding``: rows for the relative
                 positions T-1 .. -(T-1), sin on even and cos on odd
                 channels, the positive half flipped and the negative half
                 after it, as fairseq builds it
  encoder        the LayerNorm before the layers unless
                 ``layer_norm_first``; each ``ConformerWav2Vec2EncoderLayer``
                 a macaron block: x + 1/2 FFN(x) (LayerNorm, w_1, swish,
                 w_2), x + rel-pos attention(LayerNorm(x)), x + the
                 convolution module (LayerNorm, pointwise conv to 2C, GLU
                 over channels, depthwise conv, BatchNorm from its running
                 statistics, swish, pointwise conv), then
                 LayerNorm(x + 1/2 FFN(x)); under ``layer_norm_first`` the
                 encoder's LayerNorm after the last layer
                 (``TransformerEncoder.forward``, inherited)
  attention      espnet's ``RelPositionMultiHeadedAttention``: scores
                 ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_k), p the
                 table through ``linear_pos`` (no bias), masked keys at
                 -inf, softmax, times v, ``linear_out``

Departures from fairseq: the pre-training modules (``mask_emb``, the
quantizer, ``project_q``, ``final_proj``) and the encoder's inherited
positional conv, which a conformer never runs, have no leaves; dropout and
layerdrop are off (a served model is in eval). Every product and
convolution reads its operands through ``q`` (``QUANT``, as
``reference/model.py`` rounds them).

This configuration has no train cell: the training entries of the
contract raise ``NotImplementedError``. ``call_launches`` and
``step_launches`` are empty: no kernel family of ``kernels/`` runs in this
model. ``relpos_work`` counts the relative-position core's work, which
``metrics/relpos_roofline_pct.py`` and ``student_fwd_flops`` read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..work import conv_stack_flops
from . import Spec
from .model import QUANT, conv_out_lengths, identity, layer_norm  # noqa: F401 (QUANT)

Params = Dict[str, torch.Tensor]

NO_TRAIN = "the w2v2_conformer reference serves only: its configuration has no train cell"


# ------------------------------------------------------------ parameters
LN_BIAS = 0.25  # a LayerNorm's bias is drawn uniform in [-LN_BIAS, LN_BIAS]
# linear_pos is drawn at POS_GAIN times lecun normal: the position scores
# then spread as a trained model's do (a row's attention entropy ~2.9 nats
# of 6.7 at 849 frames), where at lecun normal they are nearly uniform
# (~4.8 of 5.0 at 149 frames) and the scores barely depend on the offset
POS_GAIN = 8.0


def _norm(key: str, d: int) -> Spec:
    """A LayerNorm: weight one, bias drawn (a trained model's is not zero,
    and at zero the encoder's LayerNorm after the last layer's own would be
    an identity that no comparison could see)."""
    return [(f"{key}.weight", (d,), "fill", 1.0), (f"{key}.bias", (d,), "uniform", LN_BIAS)]


def _dense(key: str, d_in: int, d_out: int, bias: bool = True, gain: float = 1.0) -> Spec:
    """A conformer Linear: lecun normal (std fan_in^-0.5) times ``gain``,
    zero bias."""
    out = [(f"{key}.weight", (d_out, d_in), "normal", gain * d_in ** -0.5)]
    return out + ([(f"{key}.bias", (d_out,), "fill", 0.0)] if bias else [])


def _ffn(pre: str, e: int, f: int) -> Spec:
    return _norm(f"{pre}.layer_norm", e) + _dense(f"{pre}.w_1", e, f) + _dense(f"{pre}.w_2", f, e)


def _layer_spec(pre: str, e: int, f: int, heads: int, k: int) -> Spec:
    dk = e // heads
    bound = math.sqrt(6.0 / (heads + dk))  # xavier uniform over (H, d_k)
    attn = f"{pre}.self_attn"
    conv = f"{pre}.conv_module"
    out = _ffn(f"{pre}.ffn1", e, f) + _norm(f"{pre}.self_attn_layer_norm", e)
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        out += _dense(f"{attn}.{name}", e, e)
    out += _dense(f"{attn}.linear_pos", e, e, bias=False, gain=POS_GAIN)
    out += [(f"{attn}.pos_bias_u", (heads, dk), "uniform", bound),
            (f"{attn}.pos_bias_v", (heads, dk), "uniform", bound)]
    out += _norm(f"{conv}.layer_norm", e)
    out += [(f"{conv}.pointwise_conv1.weight", (2 * e, e, 1), "normal", e ** -0.5),
            (f"{conv}.depthwise_conv.weight", (e, 1, k), "normal", k ** -0.5),
            (f"{conv}.batch_norm.weight", (e,), "fill", 1.0),
            (f"{conv}.batch_norm.bias", (e,), "fill", 0.0),
            (f"{conv}.batch_norm.running_mean", (e,), "fill", 0.0),
            (f"{conv}.batch_norm.running_var", (e,), "fill", 1.0),
            (f"{conv}.pointwise_conv2.weight", (e, e, 1), "normal", e ** -0.5)]
    return out + _ffn(f"{pre}.ffn2", e, f) + _norm(f"{pre}.final_layer_norm", e)


def student_spec(d: Dict, export: bool = False) -> Spec:
    """The served model's leaves (it has no heads, so ``export`` changes
    nothing), at the program's initialiser scales (``init_parameters``):
    extractor convs kaiming normal with torch's uniform conv bias, the
    post-extract projection normal at fan_in^-0.5, the conformer's Linears
    and bias-free convs lecun normal, ``pos_bias_u`` / ``pos_bias_v`` xavier
    uniform, BatchNorm at one and zero with running statistics 0 and 1;
    and, unlike the initialiser, each LayerNorm's bias uniform in
    [-``LN_BIAS``, ``LN_BIAS``] (its weight one) and ``linear_pos`` at
    ``POS_GAIN`` times lecun normal."""
    if d["extractor_mode"] != "layer_norm":
        raise NotImplementedError("the w2v2_conformer reference has the layer_norm extractor")
    out: Spec = []
    c_in = 1
    for i, (c, k, _s) in enumerate(d["conv_feature_layers"]):
        fan = c_in * k
        pre = f"feature_extractor.conv_layers.{i}"
        out.append((f"{pre}.0.weight", (c, c_in, k), "normal", math.sqrt(2.0 / fan)))
        if d["conv_bias"]:
            out.append((f"{pre}.0.bias", (c,), "uniform", fan ** -0.5))
        out += _norm(f"{pre}.2.1", c)
        c_in = c
    e = d["encoder_embed_dim"]
    out += _norm("layer_norm", c_in)
    if c_in != e:
        out += [("post_extract_proj.weight", (e, c_in), "normal", c_in ** -0.5),
                ("post_extract_proj.bias", (e,), "fill", 0.0)]
    out += _norm("encoder.layer_norm", e)
    for i in range(d["encoder_layers"]):
        out += _layer_spec(f"encoder.layers.{i}", e, d["encoder_ffn_embed_dim"],
                           d["encoder_attention_heads"], d["depthwise_conv_kernel_size"])
    return out


# ------------------------------------------------------------ forward
def _mm(x, P: Params, key: str, q):
    return F.linear(q(x), q(P[f"{key}.weight"]), P.get(f"{key}.bias"))


def extractor(P: Params, layers, wav: torch.Tensor, q) -> torch.Tensor:
    """(B, T_wav) -> (B, T', C): conv with bias, LayerNorm over channels,
    GELU, block by block."""
    x = wav[:, None, :]
    for i, (c, _k, s) in enumerate(layers):
        pre = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(q(x), q(P[f"{pre}.0.weight"]), P.get(f"{pre}.0.bias"), stride=s)
        x = layer_norm(P, f"{pre}.2.1", x.transpose(1, 2)).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def rel_positions(t: int, e: int, device) -> torch.Tensor:
    """espnet's ``RelPositionalEncoding`` rows for positions T-1 .. -(T-1),
    (2T-1, e), built as fairseq builds them."""
    position = torch.arange(0, t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, e, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / e))
    pos = torch.zeros(t, e, device=device)
    neg = torch.zeros(t, e, device=device)
    pos[:, 0::2] = torch.sin(position * div)
    pos[:, 1::2] = torch.cos(position * div)
    neg[:, 0::2] = torch.sin(-1 * position * div)
    neg[:, 1::2] = torch.cos(-1 * position * div)
    return torch.cat([torch.flip(pos, [0]), neg[1:]])


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """espnet's ``rel_shift`` as fairseq writes it: (B, H, T, 2T-1) scores
    against the table's rows -> (B, H, T, T), a zero column prepended, the
    rows re-cut and the first T positions kept."""
    b, h, t, n = x.shape
    padded = torch.cat([x.new_zeros(b, h, t, 1), x], dim=-1).view(b, h, n + 1, t)
    return padded[:, :, 1:].reshape(b, h, t, n)[..., : n // 2 + 1]


def rel_pos_attention(P: Params, pre: str, x: torch.Tensor, pos: torch.Tensor,
                      mask: torch.Tensor, heads: int, q) -> torch.Tensor:
    b, t, e = x.shape
    dk = e // heads
    qh = _mm(x, P, f"{pre}.linear_q", q).view(b, t, heads, dk)
    kh = _mm(x, P, f"{pre}.linear_k", q).view(b, t, heads, dk)
    vh = _mm(x, P, f"{pre}.linear_v", q).view(b, t, heads, dk)
    p = _mm(pos, P, f"{pre}.linear_pos", q).view(2 * t - 1, heads, dk)
    ac = torch.einsum("bqhd,bkhd->bhqk", q(qh + P[f"{pre}.pos_bias_u"]), q(kh))
    bd = torch.einsum("bqhd,khd->bhqk", q(qh + P[f"{pre}.pos_bias_v"]), q(p))
    scores = (ac + rel_shift(bd)) / math.sqrt(dk)
    scores = scores.masked_fill(mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", q(probs), q(vh)).reshape(b, t, e)
    return _mm(out, P, f"{pre}.linear_out", q)


def feed_forward(P: Params, pre: str, x: torch.Tensor, q) -> torch.Tensor:
    h = F.silu(_mm(layer_norm(P, f"{pre}.layer_norm", x), P, f"{pre}.w_1", q))
    return _mm(h, P, f"{pre}.w_2", q)


def conv_module(P: Params, pre: str, x: torch.Tensor, k: int, q) -> torch.Tensor:
    e = x.shape[-1]
    y = layer_norm(P, f"{pre}.layer_norm", x).transpose(1, 2)
    y = F.glu(F.conv1d(q(y), q(P[f"{pre}.pointwise_conv1.weight"])), dim=1)
    y = F.conv1d(q(y), q(P[f"{pre}.depthwise_conv.weight"]), padding=(k - 1) // 2, groups=e)
    bn = f"{pre}.batch_norm"
    y = F.batch_norm(y, P[f"{bn}.running_mean"], P[f"{bn}.running_var"], P[f"{bn}.weight"],
                     P[f"{bn}.bias"], training=False, eps=1e-5)
    y = F.conv1d(q(F.silu(y)), q(P[f"{pre}.pointwise_conv2.weight"]))
    return y.transpose(1, 2)


def conformer_layer(P: Params, pre: str, x: torch.Tensor, pos: torch.Tensor,
                    mask: torch.Tensor, d: Dict, q) -> torch.Tensor:
    x = feed_forward(P, f"{pre}.ffn1", x, q) * 0.5 + x
    y = layer_norm(P, f"{pre}.self_attn_layer_norm", x)
    x = rel_pos_attention(P, f"{pre}.self_attn", y, pos, mask, d["encoder_attention_heads"],
                          q) + x
    x = x + conv_module(P, f"{pre}.conv_module", x, d["depthwise_conv_kernel_size"], q)
    x = feed_forward(P, f"{pre}.ffn2", x, q) * 0.5 + x
    return layer_norm(P, f"{pre}.final_layer_norm", x)


def student_forward(P: Params, d: Dict, wav: torch.Tensor, wav_mask: torch.Tensor,
                    drops=None, q=identity, export: bool = False):
    """The served forward: ``x`` (the encoder's output), ``hiddens`` (each
    layer's output) and ``mask`` (frames, True = padding)."""
    if drops is not None or not export:
        raise NotImplementedError(NO_TRAIN)
    if d["layer_type"] != "conformer" or d["pos_enc_type"] != "rel_pos":
        raise NotImplementedError("the w2v2_conformer reference is the rel_pos conformer")
    layers = d["conv_feature_layers"]
    feats = layer_norm(P, "layer_norm", extractor(P, layers, wav, q))
    lengths = conv_out_lengths((~wav_mask).sum(-1), layers)
    mask = torch.arange(feats.shape[1], device=wav.device)[None, :] >= lengths[:, None]
    crop = feats.shape[1] % d.get("crop_seq_to_multiple", 1)
    if crop:
        feats, mask = feats[:, :-crop], mask[:, :-crop]
    if "post_extract_proj.weight" in P:
        feats = _mm(feats, P, "post_extract_proj", q)
    x = feats.masked_fill(mask[..., None], 0.0)
    pos = rel_positions(x.shape[1], x.shape[2], x.device)
    if not d["layer_norm_first"]:
        x = layer_norm(P, "encoder.layer_norm", x)
    hiddens: List[torch.Tensor] = []
    for i in range(d["encoder_layers"]):
        x = conformer_layer(P, f"encoder.layers.{i}", x, pos, mask, d, q)
        hiddens.append(x)
    if d["layer_norm_first"]:
        x = layer_norm(P, "encoder.layer_norm", x)
    return {"x": x, "hiddens": hiddens, "mask": mask}


# ------------------------------------------------------------ work
def relpos_work(d: Dict, lengths: Sequence[int], el: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of the relative-position core (the two score
    products, rel_shift, the mask, softmax, P V) over rows of the given
    unpadded sample lengths, each at its own t frames, in every layer:
    3 x 2 t^2 H d_k FLOPs (Q K^T, the position term at the t^2 offsets
    rel_shift keeps, P V), and q, k, v, the 2t - 1 position rows and the
    output read or written once in bf16 (``el`` bytes). It counts the work,
    whatever computes it."""
    e, n_layers = d["encoder_embed_dim"], d["encoder_layers"]
    flops = bytes_ = 0
    for n in lengths:
        t = max(conv_stack_flops(d["conv_feature_layers"], n)[1], 0)
        flops += n_layers * 3 * 2 * t * t * e
        bytes_ += n_layers * (4 * t + 2 * t - 1) * e * el if t else 0
    return flops, bytes_


def student_fwd_flops(d: Dict, n: int, live_heads=None) -> int:
    """Matmul and conv FLOPs of one served forward over n samples at its own
    frames: the extractor, ``post_extract_proj``, and per layer the two
    FFNs, the q / k / v / out projections, ``linear_pos`` over the 2t - 1
    table rows, the relative-position core (``relpos_work``) and the
    convolution module's pointwise and depthwise convs. The model has no
    heads (``live_heads`` is the contract's and changes nothing)."""
    fl, t = conv_stack_flops(d["conv_feature_layers"], n)
    t, c = max(t, 0), d["conv_feature_layers"][-1][0]
    e, f, k = d["encoder_embed_dim"], d["encoder_ffn_embed_dim"], d["depthwise_conv_kernel_size"]
    if c != e:
        fl += 2 * t * c * e
    per_layer = (2 * 2 * (2 * t * e * f)  # ffn1, ffn2: w_1 and w_2
                 + 4 * 2 * t * e * e  # q, k, v, out
                 + 2 * (2 * t - 1) * e * e * (t > 0)  # linear_pos over the table
                 + 2 * t * e * 2 * e + 2 * t * e * k + 2 * t * e * e)  # the conv module
    return fl + d["encoder_layers"] * per_layer + relpos_work(d, [n])[0]


def call_launches(cfg: Dict, lengths: Sequence[int], t_pad: int) -> list:
    return []


def step_launches(cfg: Dict, lengths: Sequence[int], t_pad: int) -> list:
    return []


# ------------------------------------------------------------ no train cell
def teacher_spec(g: Dict) -> Spec:
    raise NotImplementedError(NO_TRAIN)


def teacher_forward(P: Params, g: Dict, wav: torch.Tensor, wav_mask: torch.Tensor, q=identity):
    raise NotImplementedError(NO_TRAIN)


def kd_loss(loss: Dict, d: Dict, proj, teacher_hiddens, rand_layers):
    raise NotImplementedError(NO_TRAIN)


def kd_step_flops(d: Dict, g: Dict, lengths: Sequence[int]) -> int:
    raise NotImplementedError(NO_TRAIN)
