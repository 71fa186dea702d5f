"""The KD loss (``fithubert_tpu/train/losses.py:115 compute_losses``): the
rec MSE / L1 over random or fixed layers (``pred_layer_id``, from the
layer-wise heads or the SplitLinear head's (B, N, T, D) projections), the
-logsigmoid cosine-similarity term, the cnn term, the attention-transfer
terms on the last layer's taps: the attention-logit loss (mse or kldiv)
and the value-relation KL (``:307-361``), and for a task-specific
(wav2vec_ctc) teacher the CTC term (``:363-388``) against ground-truth or
``collapse_pseudo_labels`` labels.

Parity mode (``masked_reduction=False``) reduces over padded positions as
the reference does, but weights out rows fabricated as all padding
(``_row_weighted_mean``, ``:51-69``); masked mode divides by valid
positions (``:79-87``). All loss math is fp32.

Under data parallelism each rank holds a stripe of the global batch and
``compute_losses`` takes ``global_sum``, the sum of a tensor over the
ranks: every denominator (real rows, valid positions, the attention loss's
scrub counts) is the global batch's, so each rank's loss is its share of
the global loss. The shares, and their gradients, sum over the ranks to
what one process computes on the whole batch. Without ``global_sum`` (one
process) every value is unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from fithubert_tpu_torch.config import LossConfig, StudentConfig
from fithubert_tpu_torch.models.student import StudentOutput
from fithubert_tpu_torch.models.teacher import TeacherOutput


Sum = Callable[[torch.Tensor], torch.Tensor]  # a tensor summed over the ranks


def _local(x: torch.Tensor) -> torch.Tensor:
    return x


class LossOutput(NamedTuple):
    total: torch.Tensor
    logs: Dict[str, torch.Tensor]  # per-term and per-layer scalars
    last_layer_loss: torch.Tensor  # 'l{N-1}', the v_loss monitor


def _as_stack(projections: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
    if isinstance(projections, (list, tuple)):
        return torch.stack(list(projections), dim=1)
    return projections


def _row_weighted_mean(x: torch.Tensor, rv: Optional[torch.Tensor],
                       keep_axis1: bool = False, gsum: Sum = _local) -> torch.Tensor:
    """Mean over all axes (but axis 1 when ``keep_axis1``), with batch row b
    weighted by rv[b] (1 real, 0 fabricated); a plain mean when rv is None."""
    if rv is None:
        return x.mean(dim=(0,) + tuple(range(2, x.dim()))) if keep_axis1 else x.mean()
    w = rv.to(x.dtype)
    denom = gsum(w.sum()).clamp_min(1.0)
    if keep_axis1:
        per = x.mean(dim=tuple(range(2, x.dim())))  # (B, L)
        return (per * w[:, None]).sum(0) / denom
    per = x.mean(dim=tuple(range(1, x.dim())))  # (B,)
    return (per * w).sum() / denom


def _taps_row_weight(row_valid: Optional[torch.Tensor], z: int, device) -> torch.Tensor:
    """Row weights for (B*H, T, T) flattened attention taps (b-major)."""
    if row_valid is None:
        return torch.ones((z,), dtype=torch.float32, device=device)
    return row_valid.repeat_interleave(z // row_valid.shape[0])


def _crop_taps(pred: torch.Tensor, targ: torch.Tensor):
    """Both fp32, cropped to the leading common T x T block."""
    t_min = min(pred.shape[1], targ.shape[1])
    return pred.float()[:, :t_min, :t_min], targ.float()[:, :t_min, :t_min]


def _kl_rows(pred: torch.Tensor, targ: torch.Tensor, w: torch.Tensor, scrub: bool,
             gsum: Sum = _local):
    """Row-weighted mean over (Z, T) rows of KL(softmax(targ) || softmax(pred))."""
    logp = torch.log_softmax(pred, dim=-1)
    q = torch.softmax(targ, dim=-1)
    kl = q * (torch.log(q.clamp_min(1e-30)) - logp)
    if scrub:  # torch.where: the NaN branch gets no gradient
        kl = torch.where(torch.isinf(kl) | torch.isnan(kl), 0.0, kl)
    return (kl.sum(-1) * w[:, None]).sum() / gsum(w.sum() * kl.shape[1]).clamp_min(1.0)


def attention_loss(pred_a: torch.Tensor, targ_a: torch.Tensor,
                   row_valid: Optional[torch.Tensor], loss_type: str,
                   gsum: Sum = _local) -> torch.Tensor:
    """The attention-logit transfer (``:307-337``) between (B*H, T, T)
    logits, -inf at padded keys, in fp32; rows of fabricated batch rows
    weigh 0."""
    pred_a, targ_a = _crop_taps(pred_a, targ_a)
    w = _taps_row_weight(row_valid, pred_a.shape[0], pred_a.device)
    if loss_type == "mse":
        with torch.no_grad():
            sq = (pred_a - targ_a) ** 2
            isinf, isnan = torch.isinf(sq), torch.isnan(sq)
            # the reference's scrub (train.py:337-341) counts whole key
            # columns; fabricated rows leave numerator and denominator
            inf_count = (isinf.any(1) * w[:, None]).sum() * sq.shape[-1]
            nan_count = (isnan.any(1) * w[:, None]).sum() * sq.shape[-1]
            bad = isinf | isnan
        # the difference is zeroed before squaring, so a -inf logit gets a
        # zero gradient rather than inf * 0
        diff = torch.where(bad, 0.0, pred_a - targ_a)
        denom = gsum(w.sum() * sq.shape[1] * sq.shape[2] - inf_count - nan_count)
        return (diff.square() * w[:, None, None]).sum() / denom.clamp_min(1.0)
    if loss_type == "kldiv":
        return _kl_rows(pred_a, targ_a, w, scrub=True, gsum=gsum)
    raise NotImplementedError("attn_loss_type must be one of 'mse', 'kldiv'.")


def value_relation_loss(pred_v: torch.Tensor, targ_v: torch.Tensor,
                        row_valid: Optional[torch.Tensor], gsum: Sum = _local) -> torch.Tensor:
    """The value-relation KL (``:339-353``) between (B*H, T, T) relations."""
    pred_v, targ_v = _crop_taps(pred_v, targ_v)
    return _kl_rows(pred_v, targ_v, _taps_row_weight(row_valid, pred_v.shape[0], pred_v.device),
                    scrub=False, gsum=gsum)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, axes: Sequence[int],
                 gsum: Sum = _local) -> torch.Tensor:
    """Mean of x over ``axes`` counting only positions where mask is False."""
    valid = torch.logical_not(mask).to(x.dtype).expand(x.shape)
    return (x * valid).sum(dim=tuple(axes)) / gsum(valid.sum(dim=tuple(axes))).clamp_min(1.0)


_LAYER_IDS: Dict[Tuple[Tuple[int, ...], str], torch.Tensor] = {}


def _layer_ids(ids: Sequence[int], device) -> torch.Tensor:
    """``ids`` as an int64 tensor on ``device``, copied there once: a step
    under a CUDA graph copies nothing from the host."""
    key = (tuple(int(i) for i in ids), str(device))
    if key not in _LAYER_IDS:
        _LAYER_IDS[key] = torch.as_tensor(key[0], dtype=torch.long, device=device)
    return _LAYER_IDS[key]


def _layer_weights(n: int, random_layer_weight: float, device) -> torch.Tensor:
    """(random_layer_weight,) * (n - 1) + (1,): the last slot is the final layer."""
    w = torch.full((n,), random_layer_weight, dtype=torch.float32, device=device)
    w[-1:].fill_(1.0)  # a kernel: no copy from the host (a CUDA graph captures it)
    return w


def collapse_pseudo_labels(ids: torch.Tensor, blank: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CTC collapse of argmax ids (B, T) at a fixed width
    (``fithubert_tpu/train/losses.py:90``): repeats merged and blanks
    dropped, the kept ids packed to the front. Returns (labels (B, T)
    int64, label_paddings (B, T) float32, 1.0 at padding)."""
    b, t = ids.shape
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    keep = (ids != prev) & (ids != blank)
    dest = torch.where(keep, keep.long().cumsum(1) - 1, torch.full_like(ids, t, dtype=torch.long))
    labels = torch.zeros((b, t + 1), dtype=torch.long, device=ids.device)
    labels.scatter_(1, dest, torch.where(keep, ids.long(), 0))  # dropped ids go to column t
    counts = keep.sum(1)
    label_paddings = (torch.arange(t, device=ids.device)[None, :] >= counts[:, None]).float()
    return labels[:, :t], label_paddings


LOG_EPSILON = -1e5  # optax.ctc_loss's stand-in for log(0)


class _TakeLabels(torch.autograd.Function):
    """``logp`` (B, T, V) at each row's labels (B, U): (B, T, U). Its
    gradient sums over a row's positions of each label in a fixed order;
    ``gather``'s backward adds them with atomics on the card, in no fixed
    order, where a label repeats."""

    @staticmethod
    def forward(ctx, logp, labels):
        ctx.save_for_backward(labels)
        ctx.vocab = logp.shape[-1]
        return logp.gather(2, labels[:, None, :].expand(-1, logp.shape[1], -1))

    @staticmethod
    def backward(ctx, grad):
        (labels,) = ctx.saved_tensors
        return torch.stack([(grad * (labels == c)[:, None, :]).sum(-1)
                            for c in range(ctx.vocab)], dim=-1), None


def ctc_per_sequence(logits: torch.Tensor, labels: torch.Tensor,
                     label_paddings: torch.Tensor,
                     logit_paddings: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The negative log-likelihood of each row's labels under CTC, as
    ``optax.ctc_loss`` computes it: blank 0, a log-softmax over the fp32
    logits (B, T, V), frames where ``logit_paddings`` (B, T) is 1.0 and
    labels (B, U) where ``label_paddings`` is 1.0 left out; (B,) fp32.

    optax's forward recursion over T, with ``LOG_EPSILON`` standing for
    log(0): where the labels cannot be aligned in the row's frames (more
    labels, with the blanks their repeats need, than frames, as
    pseudo-labels from a teacher at a finer frame rate can be) the loss is
    a large finite penalty with a gradient, where ``F.ctc_loss`` returns
    inf; elsewhere the two agree. Its gradient is the same run to run on
    the card (``_TakeLabels``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    b, t, _ = logp.shape
    n = labels.shape[1]
    labels = labels.long()
    label_lens = n - label_paddings.float().sum(1).round().long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))  # label n == n + 1
    no_repeat = LOG_EPSILON * (1.0 - repeat)
    repeat = LOG_EPSILON * repeat
    lp_blank = logp[:, :, :1]  # (B, T, 1)
    lp_emit = _TakeLabels.apply(logp, labels)  # (B, T, U)
    phi = torch.full((b, n + 1), LOG_EPSILON, device=logp.device)
    phi[:, 0].fill_(0.0)
    emit = torch.full((b, n), LOG_EPSILON, device=logp.device)

    def add_to_tail(p, score):  # p[:, 1:] += score in log space
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=-1)

    for i in range(t):
        prev_phi = phi
        phi = add_to_tail(phi, emit + repeat)  # emit -> blank, unless the next repeats
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit[:, i], emit + lp_emit[:, i])
        next_phi = add_to_tail(phi + lp_blank[:, i], emit + lp_blank[:, i] + no_repeat)
        if logit_paddings is None:
            emit, phi = next_emit, next_phi
        else:  # a padded frame keeps the state
            pad = logit_paddings[:, i:i + 1].float()
            emit = pad * emit + (1.0 - pad) * next_emit
            phi = pad * prev_phi + (1.0 - pad) * next_phi
    phi = add_to_tail(phi, emit)
    return -phi.gather(1, label_lens[:, None])[:, 0]


def compute_losses(loss_cfg: LossConfig, student_cfg: StudentConfig,
                   student: StudentOutput, teacher: TeacherOutput,
                   rand_layers: Optional[torch.Tensor] = None,
                   global_sum: Optional[Sum] = None,
                   ctc_logits: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None,
                   label_paddings: Optional[torch.Tensor] = None,
                   logit_paddings: Optional[torch.Tensor] = None) -> LossOutput:
    """The KD loss of one (micro)batch; ``global_sum`` sums a denominator
    over the data-parallel ranks (None: this batch is the whole batch).
    With ``ctc_logits`` (B, T, V) and ``labels`` (B, U), 0 = blank or pad,
    the CTC term is added, weighted by ``ctc_loss_weight``."""
    cfg = loss_cfg
    gsum = global_sum or _local
    logs: Dict[str, torch.Tensor] = {}
    dev = teacher.x.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    frame_mask = teacher.padding_mask if cfg.masked_reduction else None
    # rows fabricated as all padding (pad_batch_to_full) weigh 0 in parity mode
    row_valid = None
    if teacher.padding_mask is not None:
        row_valid = torch.logical_not(teacher.padding_mask.all(-1)).float()
    elif global_sum is not None:  # a plain mean over the global batch
        row_valid = torch.ones(teacher.x.shape[0], dtype=torch.float32, device=dev)

    cnn_loss = zero
    if cfg.cnn_loss_weight > 0:
        sf, tf = student.features.float(), teacher.features.float()
        t_min = min(sf.shape[1], tf.shape[1])
        diff = (sf[:, :t_min] - tf[:, :t_min]).abs()
        if frame_mask is not None:
            cnn_loss = _masked_mean(diff, frame_mask[:, :t_min, None], (0, 1, 2), gsum=gsum)
        else:
            cnn_loss = _row_weighted_mean(diff, row_valid, gsum=gsum)
        logs["cnn_loss"] = cnn_loss

    teacher_stack = torch.stack([h for (h, _, _) in teacher.layer_results], dim=1)
    rec_loss, sim_loss = zero, zero
    rec_layer_loss = sim_layer_loss = None
    random_mode = cfg.distil_random_layer > 0
    slots_perm = None  # set when the random gather is skipped as a permutation

    if cfg.rec_loss_weight > 0 or cfg.sim_loss_weight > 0:
        if student.projections is None:
            raise ValueError("the rec and sim losses need the student's projections; "
                             "train.delete_projections builds none")
        proj_stack = _as_stack(student.projections)
        if random_mode:
            if rand_layers is None:
                raise ValueError("random-layer distillation needs rand_layers")
            n_slots = int(rand_layers.shape[0])
            if n_slots == teacher_stack.shape[1] - 1 == proj_stack.shape[1] - 1:
                # k = N-1 draws every intermediate layer: rand_layers is a
                # permutation and the slot weights are uniform, so the loss is
                # the same without the gathers; only the logs are permuted
                target, pred, slots_perm = teacher_stack, proj_stack, rand_layers
            else:
                ids = rand_layers.clamp(0, teacher_stack.shape[1] - 1)
                target = torch.cat([teacher_stack[:, ids], teacher_stack[:, -1:]], dim=1)
                ids = rand_layers.clamp(0, proj_stack.shape[1] - 1)
                pred = torch.cat([proj_stack[:, ids], proj_stack[:, -1:]], dim=1)
        else:
            ids = _layer_ids(student_cfg.pred_layer_id, dev)
            target = teacher_stack[:, ids]
            # layer-wise heads are gathered; the SplitLinear head predicts
            # exactly the pred_layer_id layers, in that order
            pred = proj_stack[:, ids] if student_cfg.layerwise_proj else proj_stack
        # the TR floor can leave either side a frame longer: crop both
        t_s = min(pred.shape[2], target.shape[2])
        pred, target = pred[:, :, :t_s].float(), target[:, :, :t_s].float()
        layer_mask = frame_mask[:, None, :t_s, None] if frame_mask is not None else None

    if cfg.rec_loss_weight > 0:
        if cfg.rec_loss_type == "l1":
            elt = (pred - target).abs()
        elif cfg.rec_loss_type == "mse":
            elt = (pred - target) ** 2
        else:
            raise NotImplementedError("rec_loss_type must be one of 'l1', 'mse'.")
        if random_mode:
            elt = elt * _layer_weights(elt.shape[1], cfg.random_layer_weight, dev)[
                None, :, None, None]
            if layer_mask is not None:
                rec_layer_loss = _masked_mean(elt, layer_mask, (0, 2, 3), gsum=gsum)
            else:
                rec_layer_loss = _row_weighted_mean(elt, row_valid, keep_axis1=True, gsum=gsum)
            rec_loss = rec_layer_loss.sum()
        elif layer_mask is not None:
            rec_layer_loss = _masked_mean(elt, layer_mask, (0, 2, 3), gsum=gsum)
            rec_loss = rec_layer_loss.mean()
        else:
            rec_layer_loss = _row_weighted_mean(elt, row_valid, keep_axis1=True,
                                                gsum=gsum).detach()
            rec_loss = _row_weighted_mean(elt, row_valid, gsum=gsum)

    if cfg.sim_loss_weight > 0:
        # F.cosine_similarity with torch's eps = 1e-8 clamp of the product
        dot = (pred * target).sum(-1)
        norms = pred.square().sum(-1).sqrt() * target.square().sum(-1).sqrt()
        elt = -F.logsigmoid(dot / norms.clamp_min(1e-8))  # (B, N, T)
        sim_mask = frame_mask[:, None, : elt.shape[2]] if frame_mask is not None else None
        if random_mode:
            elt = elt * _layer_weights(elt.shape[1], cfg.random_layer_weight, dev)[
                None, :, None]
            if sim_mask is not None:
                sim_layer_loss = _masked_mean(elt, sim_mask, (0, 2), gsum=gsum)
            else:
                sim_layer_loss = _row_weighted_mean(elt, row_valid, keep_axis1=True, gsum=gsum)
            sim_loss = sim_layer_loss.sum()
        elif sim_mask is not None:
            sim_layer_loss = _masked_mean(elt, sim_mask, (0, 2), gsum=gsum)
            sim_loss = sim_layer_loss.mean()
        else:
            sim_layer_loss = _row_weighted_mean(elt, row_valid, keep_axis1=True,
                                                gsum=gsum).detach()
            sim_loss = _row_weighted_mean(elt, row_valid, gsum=gsum)

    last_layer_loss = None
    if rec_layer_loss is not None or sim_layer_loss is not None:
        feat_layer = sum(t for t in (rec_layer_loss, sim_layer_loss) if t is not None)
        if slots_perm is not None:
            # slot i distilled layer rand_layers[i]
            feat_layer = torch.cat([feat_layer[slots_perm.clamp(0, feat_layer.shape[0] - 1)],
                                    feat_layer[-1:]])
        if random_mode:
            for i in range(feat_layer.shape[0] - 1):
                logs[f"rand_l{i}"] = feat_layer[i]
            logs[f"l{student_cfg.encoder_layers - 1}"] = feat_layer[-1]
        else:
            for i, pid in enumerate(student_cfg.pred_layer_id):
                logs[f"layer{pid}"] = feat_layer[i]
        last_layer_loss = feat_layer[-1]

    attn_loss = v_rel_loss = zero
    if cfg.attn_loss_weight > 0:
        attn_loss = attention_loss(student.layer_results[-1][1].attn_logits,
                                   teacher.layer_results[-1][1].attn_logits, row_valid,
                                   cfg.attn_loss_type, gsum)
        logs["attn_loss"] = attn_loss
    if cfg.v_rel_loss_weight > 0:
        v_rel_loss = value_relation_loss(student.layer_results[-1][1].v_rel,
                                         teacher.layer_results[-1][1].v_rel, row_valid, gsum)
        logs["v_rel_loss"] = v_rel_loss

    total = (cfg.rec_loss_weight * rec_loss + cfg.sim_loss_weight * sim_loss
             + cfg.attn_loss_weight * attn_loss + cfg.v_rel_loss_weight * v_rel_loss
             + cfg.cnn_loss_weight * cnn_loss)
    if ctc_logits is not None and labels is not None:
        if label_paddings is None:
            label_paddings = (labels == 0).float()
        per_seq = ctc_per_sequence(ctc_logits, labels, label_paddings, logit_paddings)
        rv = row_valid if row_valid is not None else torch.ones_like(per_seq)
        ctc = (per_seq * rv).sum() / gsum(rv.sum()).clamp_min(1.0)
        logs["ctc_loss"] = ctc
        total = total + cfg.ctc_loss_weight * ctc
    logs["total"] = total
    if last_layer_loss is None:
        last_layer_loss = zero if random_mode else total
    return LossOutput(total=total, logs=logs, last_layer_loss=last_layer_loss)
