"""Frozen-feature downstream probe on an export of the port
(``scripts/linear_probe.py``): the SUPERB-workflow proxy.

The reference is made to feed s3prl downstream heads (``run_downstream.py
-u fithubert``): the upstream is frozen and a small head trains on its
features. This module does the same standalone:

    1. load the exported student through ``UpstreamExpert`` (the
       ``student.yaml`` + ``student.pt`` pair, or a reference Lightning
       ``.ckpt``),
    2. extract frozen features of labelled synthetic waveforms,
    3. train a head on them (the upstream never updates): a framewise
       linear softmax (``run_probe``) or a CTC sequence head, greedy-decoded
       and scored by CER on held-out utterances (``run_ctc_probe``),
    4. report it against a control trained on the same features with the
       labels shuffled, which only features that carry the task can beat.

    python -m fithubert_tpu_torch.scripts.linear_probe --ckpt run/student.pt \\
        --config run/student.yaml [--device cuda|cpu] [--n-utts 24] \\
        [--classes 4] [--steps 300] [--layer -1] [--ctc]

It prints one JSON line of the result, then ``PROBE PASSED|FAILED`` (or
``CTC PROBE ...``), and exits 1 where the probe does not beat the control:
framewise, accuracy above the control's by more than 0.2 and a lower loss;
CTC, a CER below the control's by more than 0.2. The datasets, the heads,
their initial draws' shapes and scales, the optimisers and these rules are
the JAX script's; the heads' first weights come from ``torch.Generator``
(an ``init`` of numpy arrays replaces them). The expert, the heads and their
training run on the card unless ``--device cpu`` is given; on the card the
CTC head's steps replay as one CUDA graph.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.train.losses import ctc_per_sequence
from fithubert_tpu_torch.utils.text import cer

SR = 16_000


def make_tone_dataset(
    n_utts: int, n_classes: int, seed: int = 0, dur_range=(0.8, 1.6)
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Labeled waveforms: class c = harmonic tone in a distinct f0 band
    (+noise, random phase/duration). A linear probe over informative frame
    features separates these; over label-shuffled features it cannot."""
    rng = np.random.default_rng(seed)
    wavs, labels = [], []
    for i in range(n_utts):
        c = i % n_classes
        # octave-spaced bands: within-class jitter stays far from the
        # neighboring class at every class count
        f0 = 125.0 * (2.0 ** c) + rng.uniform(-15.0, 15.0)
        n = int(rng.uniform(*dur_range) * SR)
        t = np.arange(n) / SR
        phase = rng.uniform(0, 2 * np.pi)
        sig = (
            0.5 * np.sin(2 * np.pi * f0 * t + phase)
            + 0.25 * np.sin(2 * np.pi * 2 * f0 * t + phase)
            + 0.05 * rng.standard_normal(n)
        )
        wavs.append(sig.astype(np.float32))
        labels.append(c)
    return wavs, np.asarray(labels, np.int32)


def _valid_frames(pad: Optional[np.ndarray], j: int, n_wav: int, t_hid: int,
                  t_max: int) -> np.ndarray:
    """Row j's valid frames of a (B, t_hid) hidden state: from the padding
    mask where it is at the hidden rate, else derived from the waveform's
    length against the longest of the batch (``t_max``), which sets t_hid."""
    if pad is not None and pad.shape[1] == t_hid:
        return ~pad[j]
    n_frames = min(t_hid, int(n_wav * t_hid / (t_max + 1e-9)) or 1)
    return np.arange(t_hid) < n_frames


def _host(x) -> Optional[np.ndarray]:
    """A tensor of the expert's output on the host (hidden states as fp32)."""
    if x is None:
        return None
    x = x.detach()
    return (x if x.dtype == torch.bool else x.float()).cpu().numpy()


def extract_sequences(expert, wavs, layer: int = -1, batch_size: int = 8) -> List[np.ndarray]:
    """Frozen per-utterance frame-feature sequences [(T_i, D)] fp32 on the
    host: ``hidden_states[layer]`` (-1: the last encoder hidden, the s3prl
    surface downstream heads consume) at each row's valid frames."""
    seqs = []
    for i in range(0, len(wavs), batch_size):
        chunk = list(wavs[i: i + batch_size])
        with torch.no_grad():
            out = expert(chunk)
        hs, pad = _host(out["hidden_states"][layer]), _host(out["padding_mask"])
        t_max = max(len(w) for w in chunk)
        for j, w in enumerate(chunk):
            valid = _valid_frames(pad, j, len(w), hs.shape[1], t_max)
            seqs.append(np.asarray(hs[j][valid], np.float32))
    return seqs


def extract_frame_features(
    expert, wavs: Sequence[np.ndarray], labels: np.ndarray, layer: int = -1,
    batch_size: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Frozen features of every VALID frame (N, D) and per-frame labels (N,)."""
    seqs = extract_sequences(expert, wavs, layer, batch_size)
    x = np.concatenate(seqs, axis=0)
    y = np.concatenate([np.full(len(f), labels[i], np.int32) for i, f in enumerate(seqs)],
                       axis=0)
    return x, y


def _standardise(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(axis=0, keepdims=True), feats.std(axis=0, keepdims=True) + 1e-6


def train_linear_probe(
    feats: np.ndarray, labels: np.ndarray, n_classes: int,
    steps: int = 300, lr: float = 0.05, seed: int = 0, device="cuda",
    init: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[float, float]:
    """Full-batch softmax regression on FROZEN features, standardised: a
    (D, C) head, w drawn N(0, 1) * 0.01 from ``torch.Generator`` seeded with
    ``seed`` (``init["w"]`` instead, where given) and b = 0, trained with
    Adam(lr) on the mean cross-entropy. Returns (the loss of the last step,
    the accuracy after it)."""
    dev = resolve_device(device)
    mu, sd = _standardise(feats)
    x = torch.from_numpy((feats - mu) / sd).to(dev)
    y = torch.from_numpy(np.asarray(labels)).long().to(dev)
    d = x.shape[1]
    if init is None:
        w0 = torch.randn(d, n_classes, generator=torch.Generator().manual_seed(seed)) * 0.01
    else:
        w0 = torch.tensor(np.asarray(init["w"], np.float32))  # a copy: the head trains in place
    w = w0.to(dev).requires_grad_()
    b = torch.zeros(n_classes, device=dev, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr)
    loss = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(x @ w + b, y)
        loss.backward()
        opt.step()
    with torch.no_grad():
        pred = (x @ w + b).argmax(-1).cpu().numpy()
    return float(loss.detach()), float((pred == np.asarray(labels)).mean())


def run_probe(expert, n_utts: int = 24, n_classes: int = 4, steps: int = 300,
              layer: int = -1, seed: int = 0) -> Dict[str, float]:
    """The framewise probe against a label-shuffled control on the expert's
    device. Returns a result dict."""
    wavs, labels = make_tone_dataset(n_utts, n_classes, seed=seed)
    feats, frame_labels = extract_frame_features(expert, wavs, labels, layer)
    dev = expert.device
    loss, acc = train_linear_probe(feats, frame_labels, n_classes, steps, device=dev)
    # control: identical features, labels shuffled -> no learnable mapping
    rng = np.random.default_rng(seed + 1)
    shuffled = frame_labels[rng.permutation(len(frame_labels))]
    c_loss, c_acc = train_linear_probe(feats, shuffled, n_classes, steps, device=dev)
    return {
        "probe_loss": loss,
        "probe_acc": acc,
        "control_loss": c_loss,
        "control_acc": c_acc,
        "n_frames": int(len(frame_labels)),
        "feature_dim": int(feats.shape[1]),
        "chance": 1.0 / n_classes,
    }


# ------------------------------------------------------- CTC sequence probe
# One level up from framewise tone classification: the SUPERB ASR
# downstream is sequence transduction, a CTC head over frozen frames,
# greedy-decoded and scored by edit distance. This probe exercises the
# frame-rate, blank and alignment contract that workflow depends on.

CTC_ALPHABET = "abcd"


def make_spoken_dataset(
    n_utts: int, seed: int = 0, n_letters=(3, 6), letter_sec: float = 0.25
) -> Tuple[List[np.ndarray], List[str]]:
    """Synthetic 'speech': each utterance is a random letter string from a
    4-letter alphabet, each letter rendered as a PURE tone in a distinct
    frequency band for `letter_sec`, separated by silences long enough to
    survive the student's time reduction as blank frames. The waveform
    ENCODES the transcript, so a CTC head over frequency-preserving frozen
    features can transcribe it, and cannot transcribe shuffled targets.

    Pure tones at non-harmonic spacing: an octave-spaced HARMONIC alphabet
    (like make_tone_dataset's) puts class c's 2*f0 partial exactly on class
    c+1's fundamental, which collapses the higher letters under a linear
    CTC head (they decode as blank)."""
    rng = np.random.default_rng(seed)
    f0s = (160.0, 330.0, 700.0, 1500.0)  # no f0 multiple hits another band
    wavs, texts = [], []
    for _ in range(n_utts):
        k = int(rng.integers(n_letters[0], n_letters[1] + 1))
        text = "".join(rng.choice(list(CTC_ALPHABET), size=k))
        segs = []
        for ch in text:
            f0 = f0s[CTC_ALPHABET.index(ch)] * rng.uniform(0.97, 1.03)
            n = int(letter_sec * SR * rng.uniform(0.9, 1.1))
            t = np.arange(n) / SR
            seg = 0.6 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
            # fade in/out to avoid clicks, then a silence gap (blank frames —
            # must span >= a few POST-time-reduction frames or repeated
            # letters become indistinguishable from one long one)
            ramp = min(len(seg) // 8, 320)
            seg[:ramp] *= np.linspace(0, 1, ramp)
            seg[-ramp:] *= np.linspace(1, 0, ramp)
            segs.append(seg)
            segs.append(np.zeros(int(0.15 * SR)))
        wav = np.concatenate(segs) + 0.02 * rng.standard_normal(
            sum(len(s) for s in segs))
        wavs.append(wav.astype(np.float32))
        texts.append(text)
    return wavs, texts


def _greedy_ctc_decode(logits: np.ndarray, n_frames: int) -> str:
    """argmax -> collapse repeats -> drop blanks (blank id 0)."""
    ids = logits[:n_frames].argmax(-1)
    out, prev = [], 0
    for i in ids:
        if i != prev and i != 0:
            out.append(CTC_ALPHABET[i - 1])
        prev = i
    return "".join(out)


def _pack_ctc_batch(seqs, texts, mu, sd):
    t_max = max(s.shape[0] for s in seqs)
    l_max = max(len(t) for t in texts)
    b = len(seqs)
    x = np.zeros((b, t_max, seqs[0].shape[1]), np.float32)
    xpad = np.ones((b, t_max), np.float32)
    y = np.zeros((b, l_max), np.int32)
    ypad = np.ones((b, l_max), np.float32)
    for j, (s, txt) in enumerate(zip(seqs, texts)):
        x[j, : s.shape[0]] = (s - mu) / sd
        xpad[j, : s.shape[0]] = 0.0
        ids = [1 + CTC_ALPHABET.index(c) for c in txt]
        y[j, : len(ids)] = ids
        ypad[j, : len(ids)] = 0.0
    return x, xpad, y, ypad


def cosine_lr(lr: float, steps: int, k: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps)`` at update k."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps))


def _ctc_head(p, x):
    return torch.relu(x @ p[0] + p[1]) @ p[2] + p[3]


def train_ctc_probe(
    seqs, texts: Sequence[str], steps: int = 6000, lr: float = 0.05,
    seed: int = 0, eval_seqs=None, eval_texts=None, hidden: int = 64, device="cuda",
    init: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[float, float]:
    """A small CTC head (D -> hidden ReLU -> blank + alphabet) on FROZEN
    feature sequences, full batch: w1 N(0, 1) / sqrt(D) and w2 N(0, 1) *
    0.01 from ``torch.Generator`` seeded with ``seed`` (``init["w1"]`` and
    ``init["w2"]`` instead, where given), zero biases; AdamW (weight decay
    1e-3 on every parameter) at the cosine-decayed rate ``cosine_lr``; the
    loss is the mean of ``ctc_per_sequence``, optax's CTC recursion.
    Returns (the loss of the last step, the greedy-decode CER), the CER
    scored on the held-out (eval_seqs, eval_texts) where given, else on
    the training utterances.

    Why not a linear head: over a randomly initialised upstream, attention
    mixes the whole utterance into every frame, so even a linear head
    memorises shuffled training transcripts while the true ones stick in a
    blank-heavy optimum; one hidden layer gives the optimiser a way out,
    and held-out scoring separates the tone solution (it generalises) from
    memorisation (it does not)."""
    return train_ctc_probes(seqs, [texts], steps, lr, seed, eval_seqs, eval_texts, hidden,
                            device, init)[0]


def train_ctc_probes(
    seqs, text_sets: Sequence[Sequence[str]], steps: int = 6000, lr: float = 0.05,
    seed: int = 0, eval_seqs=None, eval_texts=None, hidden: int = 64, device="cuda",
    init: Optional[Dict[str, np.ndarray]] = None,
) -> List[Tuple[float, float]]:
    """One head per transcript set of ``text_sets``, each trained as
    ``train_ctc_probe`` trains it (the same first draw for every head), side
    by side on the same frames: the heads' logits go through
    ``ctc_per_sequence`` as one batch, row by row as apart (labels padded
    to the longest set's, which moves a shorter set's last bits), and each
    head's loss is its own rows' mean. On the card a step of every head
    replays as one CUDA graph. Returns each head's (loss, CER)."""
    dev = resolve_device(device)
    n_cls, k = 1 + len(CTC_ALPHABET), len(text_sets)
    mu, sd = _standardise(np.concatenate(seqs, axis=0))
    packed = [_pack_ctc_batch(seqs, texts, mu, sd) for texts in text_sets]
    u = max(p[2].shape[1] for p in packed)  # labels padded to the longest set's
    x, xpad = (torch.from_numpy(a).to(dev) for a in packed[0][:2])
    y = torch.from_numpy(np.concatenate([np.pad(p[2], ((0, 0), (0, u - p[2].shape[1])))
                                         for p in packed])).to(dev)
    ypad = torch.from_numpy(np.concatenate([np.pad(p[3], ((0, 0), (0, u - p[3].shape[1])),
                                                   constant_values=1.0)
                                            for p in packed])).to(dev)
    xpads = xpad.repeat(k, 1)
    d = x.shape[-1]
    if init is None:
        g = torch.Generator().manual_seed(seed)
        w1 = torch.randn(d, hidden, generator=g) / np.sqrt(d)
        w2 = torch.randn(hidden, n_cls, generator=g) * 0.01
    else:
        w1, w2 = (torch.tensor(np.asarray(init[k_], np.float32)) for k_ in ("w1", "w2"))
    heads = [[w1.to(dev, torch.float32, copy=True), torch.zeros(hidden, device=dev),
              w2.to(dev, torch.float32, copy=True), torch.zeros(n_cls, device=dev)]
             for _ in range(k)]
    params = [p.requires_grad_() for head in heads for p in head]
    graphed = dev.type == "cuda"
    # optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8; on the card the
    # rate is a tensor the graph reads at each replay
    lr_now = torch.tensor(lr, device=dev) if graphed else lr
    opt = torch.optim.AdamW(params, lr=lr_now, weight_decay=1e-3, capturable=graphed)

    def step():
        opt.zero_grad(set_to_none=not graphed)
        logits = torch.cat([_ctc_head(head, x) for head in heads])
        losses = ctc_per_sequence(logits, y, ypad, xpads).view(k, -1).mean(1)
        losses.sum().backward()
        opt.step()
        return losses.detach()  # keeps no autograd graph alive into the capture

    def set_lr(i):
        if graphed:
            lr_now.fill_(cosine_lr(lr, steps, i))
        else:
            opt.param_groups[0]["lr"] = cosine_lr(lr, steps, i)

    losses = None
    if not graphed:
        for i in range(steps):
            set_lr(i)
            losses = step()
    else:
        warm = min(steps, 3)  # real steps, which also warm the graph up
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for i in range(warm):
                set_lr(i)
                losses = step()
        torch.cuda.current_stream(dev).wait_stream(side)
        if steps > warm:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                losses = step()
            for i in range(warm, steps):
                set_lr(i)
                graph.replay()
    losses = losses.tolist()

    if eval_seqs is not None:  # train-set normalization, unseen utterances
        sx, spad, _, _ = _pack_ctc_batch(eval_seqs, eval_texts, mu, sd)
        sx = torch.from_numpy(sx).to(dev)
    else:
        sx, spad = x, xpad.cpu().numpy()
    out = []
    for head, texts, loss in zip(heads, text_sets, losses):
        stexts = list(eval_texts if eval_seqs is not None else texts)
        with torch.no_grad():
            logits = _ctc_head(head, sx).cpu().numpy()
        hyps = [_greedy_ctc_decode(logits[j], int((1 - spad[j]).sum()))
                for j in range(len(stexts))]
        out.append((loss, cer(stexts, hyps)))
    return out


def run_ctc_probe(expert, n_utts: int = 60, steps: int = 6000, layer: int = -1,
                  seed: int = 0, n_eval: int = 12) -> Dict[str, float]:
    """The CTC probe against a transcript-shuffled control on the expert's
    device, scored on held-out utterances: a decisively lower probe CER
    needs the export to keep frame-level order and rate (the SUPERB-ASR
    alignment contract), not just framewise separability. Over a
    random-init upstream the probe's held-out CER is imperfect while the
    control degenerates, so the rule is the gap."""
    wavs, texts = make_spoken_dataset(n_utts, seed=seed)
    seqs = extract_sequences(expert, wavs, layer)
    # tiny smoke runs: keep at least half the utterances for training
    n_eval = min(n_eval, max(1, n_utts // 2))
    tr_s, tr_t = seqs[:-n_eval], texts[:-n_eval]
    ev_s, ev_t = seqs[-n_eval:], texts[-n_eval:]
    rng = np.random.default_rng(seed + 1)
    shuffled = [tr_t[i] for i in rng.permutation(len(tr_t))]
    # the probe and its control, side by side
    (loss, probe_cer), (c_loss, control_cer) = train_ctc_probes(
        tr_s, [tr_t, shuffled], steps, seed=seed, eval_seqs=ev_s, eval_texts=ev_t,
        device=expert.device)
    return {
        "probe_ctc_loss": loss,
        "probe_cer": probe_cer,
        "control_ctc_loss": c_loss,
        "control_cer": control_cer,
        "n_utts": n_utts,
        "n_eval": n_eval,
    }


def probe_passed(res: Dict[str, float]) -> bool:
    """The framewise rule: accuracy above the control's by more than 0.2 and
    a lower loss."""
    return res["probe_acc"] > res["control_acc"] + 0.2 and res["probe_loss"] < res["control_loss"]


def ctc_probe_passed(res: Dict[str, float]) -> bool:
    """The CTC rule: a CER below the control's by more than 0.2."""
    return res["probe_cer"] < res["control_cer"] - 0.2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="student export (.pt) or reference .ckpt")
    ap.add_argument("--config", required=True, help="the export's student yaml")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; nothing falls back to the CPU by itself")
    ap.add_argument("--n-utts", type=int, default=24)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layer", type=int, default=-1)
    ap.add_argument("--ctc", action="store_true",
                    help="run the CTC sequence-transduction probe instead")
    args = ap.parse_args(argv)

    from fithubert_tpu_torch.export.expert import UpstreamExpert

    expert = UpstreamExpert(args.ckpt, args.config, device=args.device, length_quantum=8000)
    if args.ctc:
        res = run_ctc_probe(expert, args.n_utts, args.steps, args.layer)
        print(json.dumps(res))
        ok = ctc_probe_passed(res)
        print("CTC PROBE " + ("PASSED" if ok else "FAILED")
              + f": cer {res['probe_cer']:.3f} vs control {res['control_cer']:.3f}", flush=True)
        return 0 if ok else 1
    res = run_probe(expert, args.n_utts, args.classes, args.steps, args.layer)
    print(json.dumps(res))
    ok = probe_passed(res)
    print("PROBE " + ("PASSED" if ok else "FAILED")
          + f": acc {res['probe_acc']:.3f} vs control {res['control_acc']:.3f}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
