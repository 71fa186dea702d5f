"""Length-bucketed LibriSpeech batches and synthetic batches, as numpy
arrays (``fithubert_tpu/data/librispeech.py``).

Per-split CSVs (``file_path,length``) are read, and written by scanning the
corpus where one is missing; all utterances are sorted by length,
descending, and cut into buckets of ``batch_size``. A step batch is
``{"x": (A, B, T) float32, "padding_mask": (A, B, T) bool}``, True =
padding: A accumulation microbatches padded to the group's longest
utterance, rounded up to a multiple of ``length_quantum`` samples. A
trailing group with fewer than A buckets is squared off with fabricated
all-padding microbatches, and a partial bucket with rows of all padding.
The buckets are shuffled per epoch by ``np.random.default_rng(seed +
epoch)``, and decoded ahead on a thread pool. ``batch_size`` is the
global batch: under data parallelism rank ``host_id`` of ``num_hosts``
reads rows ``host_id::num_hosts`` of each bucket padded to ``batch_size``
(a fabricated row goes to whichever rank owns its position), so every rank
has the same bucket list, padded length and number of steps. With
``load_labels`` (a wav2vec_ctc teacher's CTC term and WER/CER) a batch also
holds ``labels`` (A, B, U) int32 letter ids front-packed and
``label_paddings`` (A, B, U) float32, 1.0 at padding, from the LibriSpeech
``<spk>-<chap>.trans.txt`` beside each file, U rounded up to a multiple of
``label_quantum``; and ``_transcripts``, the texts per microbatch, which
stay on the host (a key starting with ``_``).
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import os
import queue
import threading
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fithubert_tpu_torch.config import DataConfig
from fithubert_tpu_torch.data import audio
from fithubert_tpu_torch.utils.text import LETTERS, SPECIALS, LetterDictionary, default_dict_path

Batch = Dict[str, np.ndarray]


def _check_stripe(batch_size: int, host_id: int, num_hosts: int) -> None:
    if not 0 <= host_id < num_hosts or batch_size % num_hosts:
        raise ValueError(f"rank {host_id} of {num_hosts} cannot take a stripe of a global "
                         f"batch of {batch_size}")


def _dictionary(cfg: DataConfig) -> Optional[LetterDictionary]:
    """The letter dictionary of ``load_labels`` (``dict_path``, else the
    bundled ``data/dict.ltr.txt``, else the built-in order), or None."""
    if not cfg.load_labels:
        return None
    path = cfg.dict_path or default_dict_path()
    return LetterDictionary.load(path) if os.path.exists(path) else LetterDictionary()


def label_width(t_pad: int, quantum: int) -> int:
    """U for a batch of ``t_pad`` samples: ~1 letter per 400 samples is a
    safe LibriSpeech upper bound, plus 16, rounded up to ``quantum``."""
    return quantize_length(t_pad // 400 + 16, quantum)


def load_transcript(libri_root: str, rel_path: str, cache: Dict[str, Dict[str, str]]) -> str:
    """The text of ``rel_path`` from ``<dir>/<spk>-<chap>.trans.txt`` (rows
    '<utt-id> <TEXT>'), '' where it has none; each file read once."""
    d = os.path.dirname(os.path.join(libri_root, rel_path))
    utt_id = os.path.splitext(os.path.basename(rel_path))[0]
    trans_path = os.path.join(d, "-".join(utt_id.split("-")[:2]) + ".trans.txt")
    if trans_path not in cache:
        table: Dict[str, str] = {}
        if os.path.exists(trans_path):
            with open(trans_path) as f:
                for line in f:
                    parts = line.strip().split(" ", 1)
                    if len(parts) == 2:
                        table[parts[0]] = parts[1]
        cache[trans_path] = table
    return cache[trans_path].get(utt_id, "")


def flac_num_samples(path: str) -> int:
    """Total samples from the FLAC STREAMINFO header (no decode); -1 when
    the header does not give it."""
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            return -1
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return -1
            block_type, last = hdr[0] & 0x7F, hdr[0] & 0x80
            length = (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
            body = f.read(length)
            if len(body) < length:
                return -1
            if block_type == 0 and length >= 34:
                return ((body[13] & 0x0F) << 32) | (body[14] << 24) | \
                       (body[15] << 16) | (body[16] << 8) | body[17]
            if last:
                return -1


def scan_split(libri_root: str, split: str) -> List[Tuple[str, int]]:
    """(path relative to ``libri_root``, samples) of every .flac / .wav under
    ``<libri_root>/<split>``, in sorted order. A FLAC whose header lacks the
    count, and every WAV, is decoded; a file that does not decode raises."""
    rows: List[Tuple[str, int]] = []
    for dirpath, dirs, files in os.walk(os.path.join(libri_root, split)):
        dirs.sort()
        for fn in sorted(files):
            if not fn.endswith((".flac", ".wav")):
                continue
            full = os.path.join(dirpath, fn)
            n = flac_num_samples(full) if fn.endswith(".flac") else -1
            if n <= 0:
                n = len(audio.decode(full))
            if n > 0:
                rows.append((os.path.relpath(full, libri_root), n))
    return rows


def generate_bucket_csv(libri_root: str, split: str, out_dir: str) -> str:
    """Write ``<out_dir>/<split>.csv`` by scanning the corpus, in the format
    of the reference's s3prl manifests; returns its path. The write is
    atomic, so a concurrent reader sees no CSV or a whole one."""
    rows = scan_split(libri_root, split)
    if not rows:
        raise FileNotFoundError(f"corpus not found: no .flac/.wav files under "
                                f"{os.path.join(libri_root, split)}")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{split}.csv")
    tmp_path = f"{out_path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_path", "length"])
        w.writeheader()
        for p, n in rows:
            w.writerow({"file_path": p, "length": n})
    os.replace(tmp_path, out_path)
    return out_path


def read_bucket_csvs(file_path: str, sets: Sequence[str],
                     libri_root: str = "") -> List[Tuple[str, int]]:
    """(file_path, length) rows of the splits' CSVs, longest first (a stable
    sort). A missing CSV is generated from ``libri_root``."""
    rows: List[Tuple[str, int]] = []
    for s in sets:
        csv_path = os.path.join(file_path, s + ".csv")
        if not os.path.exists(csv_path) and libri_root:
            if not os.path.isdir(os.path.join(libri_root, s)):
                raise FileNotFoundError(
                    f"corpus not found: neither bucket CSV {csv_path} nor corpus split "
                    f"{os.path.join(libri_root, s)} exists")
            print(f"[data] bucket CSV missing; scanning corpus -> {csv_path}")
            generate_bucket_csv(libri_root, s, file_path)
        with open(csv_path) as f:
            rows += [(r["file_path"], int(r["length"])) for r in csv.DictReader(f)]
    rows.sort(key=lambda t: -t[1])
    return rows


def make_buckets(rows: List[Tuple[str, int]],
                 batch_size: int) -> List[List[Tuple[str, int]]]:
    """Fixed-size buckets over the descending-length rows; a trailing bucket
    of one utterance is dropped, as the reference does."""
    buckets = [rows[i: i + batch_size] for i in range(0, len(rows), batch_size)]
    if buckets and len(buckets[-1]) <= 1:
        buckets.pop()
    return buckets


def quantize_length(length: int, quantum: int, max_length: int = 0) -> int:
    """``length`` rounded up to a multiple of ``quantum``, capped at
    ``max_length`` when that is set, and at least one quantum."""
    q = ((length + quantum - 1) // quantum) * quantum if quantum > 1 else length
    if max_length > 0:
        q = min(q, max_length)
    return max(q, quantum if quantum > 1 else length)


class BucketedLibriSpeech:
    """Step batches of padded waveforms over the buckets of ``sets``: rows
    ``host_id::num_hosts`` of each global batch of ``batch_size``."""

    def __init__(self, cfg: DataConfig, sets: Sequence[str], batch_size: int, accum: int = 1,
                 shuffle: bool = True, seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        _check_stripe(batch_size, host_id, num_hosts)
        self.dictionary = _dictionary(cfg)
        self._trans_cache: Dict[str, Dict[str, str]] = {}
        self._trans_lock = threading.Lock()
        self.cfg = cfg
        self.batch_size = batch_size
        self.host_id, self.num_hosts = host_id, num_hosts
        self.accum = max(1, accum)
        self.shuffle = shuffle
        self.seed = seed
        rows = read_bucket_csvs(cfg.bucketing_path, sets, cfg.libri_root)
        if cfg.max_wav_length > 0:
            rows = [(p, min(n, cfg.max_wav_length)) for (p, n) in rows]
        self.buckets = make_buckets(rows, batch_size)

    def __len__(self) -> int:
        # the trailing partial group trains too, squared off with fabricated
        # microbatches
        return -(-len(self.buckets) // self.accum)

    def _load_bucket(self, bucket, t_pad: int, u_pad: int) -> Batch:
        """This rank's stripe of ``bucket`` padded to the global batch: its
        real rows first, then its fabricated ones (all padding, no label)."""
        rows = (list(bucket) + [None] * (self.batch_size - len(bucket)))[
            self.host_id::self.num_hosts]
        bucket = [r for r in rows if r is not None]
        b = len(bucket)
        x = np.zeros((len(rows), t_pad), np.float32)
        mask = np.ones((len(rows), t_pad), bool)
        paths = [os.path.join(self.cfg.libri_root, p) for (p, _n) in bucket]
        x[:b], lengths = audio.decode_batch(paths, t_pad, self.cfg.num_workers)
        for i in range(b):
            n = int(lengths[i])
            if 0 < self.cfg.max_wav_length < n:
                n = self.cfg.max_wav_length
                x[i, n:] = 0.0
            mask[i, :n] = False
        out = {"x": x, "padding_mask": mask}
        if self.dictionary is not None:
            labels = np.zeros((len(rows), u_pad), np.int32)
            pads = np.ones((len(rows), u_pad), np.float32)
            texts = []
            for i, (p, _n) in enumerate(bucket):
                with self._trans_lock:
                    text = load_transcript(self.cfg.libri_root, p, self._trans_cache)
                texts.append(text)
                ids = self.dictionary.encode(text)[:u_pad]
                labels[i, :len(ids)] = ids
                pads[i, :len(ids)] = 0.0
            out.update(labels=labels, label_paddings=pads, _transcripts=texts)
        return out

    def _build_group(self, group) -> Batch:
        """One accumulation group of bucket indices -> an (A, B, T) batch;
        index -1 is a fabricated all-padding microbatch."""
        bs = [self.buckets[int(g)] if int(g) >= 0 else [] for g in group]
        t_pad = max(quantize_length(max(n for (_p, n) in b), self.cfg.length_quantum,
                                    self.cfg.max_wav_length) for b in bs if b)
        loaded = [self._load_bucket(b, t_pad, label_width(t_pad, self.cfg.label_quantum))
                  for b in bs]
        return {k: [l[k] for l in loaded] if k.startswith("_") else
                np.stack([l[k] for l in loaded]) for k in loaded[0]}

    def _groups(self, epoch_idx: int):
        order = np.arange(len(self.buckets))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        pad = (-len(order)) % self.accum
        if pad:
            order = np.concatenate([order, np.full(pad, -1, order.dtype)])
        return [order[i: i + self.accum] for i in range(0, len(order), self.accum)]

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        """The epoch's step batches, ``cfg.prefetch`` groups decoded ahead."""
        it = iter(self._groups(epoch_idx))
        with cf.ThreadPoolExecutor(max_workers=max(1, self.cfg.num_workers)) as ex:
            pending: "queue.Queue[cf.Future]" = queue.Queue()
            for _ in range(self.cfg.prefetch + 1):
                g = next(it, None)
                if g is not None:
                    pending.put(ex.submit(self._build_group, g))
            while not pending.empty():
                fut = pending.get()
                g = next(it, None)
                if g is not None:
                    pending.put(ex.submit(self._build_group, g))
                yield fut.result()


class SyntheticDataset:
    """Corpus-free step batches: harmonic sweeps plus noise, with random
    lengths in [0.8 T, T]. ``batch_size`` is global: each of ``num_hosts``
    ranks draws its ``batch_size / num_hosts`` rows from the seed folded
    with its ``host_id``, so the ranks' rows differ."""

    def __init__(self, cfg: DataConfig, batch_size: int, accum: int = 1, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1):
        _check_stripe(batch_size, host_id, num_hosts)
        self.cfg = cfg
        self.batch_size = batch_size // num_hosts
        self.accum = max(1, accum)
        self.seed = seed + 100003 * host_id

    def __len__(self) -> int:
        return max(1, self.cfg.synthetic_num_batches // self.accum)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + epoch_idx)
        t = quantize_length(self.cfg.synthetic_wav_length, self.cfg.length_quantum)
        shape = (self.accum, self.batch_size)
        for _ in range(len(self)):
            ts = np.arange(t, dtype=np.float32) / 16000.0
            f0 = rng.uniform(80, 300, size=shape + (1,))
            x = 0.1 * np.sin(2 * np.pi * f0 * ts) + 0.01 * rng.standard_normal(
                shape + (t,)).astype(np.float32)
            lengths = rng.integers(int(0.8 * t), t + 1, size=shape)
            mask = np.arange(t)[None, None, :] >= lengths[..., None]
            batch = {"x": np.where(mask, 0.0, x).astype(np.float32), "padding_mask": mask}
            if self.cfg.load_labels:
                batch.update(self._labels(rng, t))
            yield batch

    def _labels(self, rng: np.random.Generator, t: int) -> Batch:
        """Random letter ids, 4 to U / 2 a row, and their texts."""
        u_pad = label_width(t, self.cfg.label_quantum)
        n_sym = len(SPECIALS) + len(LETTERS)
        labels = np.zeros((self.accum, self.batch_size, u_pad), np.int32)
        pads = np.ones((self.accum, self.batch_size, u_pad), np.float32)
        look_up = LetterDictionary().look_up
        texts = []
        for a in range(self.accum):
            row = []
            for b in range(self.batch_size):
                u = int(rng.integers(4, max(5, u_pad // 2)))
                ids = rng.integers(4, n_sym, size=u)
                labels[a, b, :u] = ids
                pads[a, b, :u] = 0.0
                row.append(" ".join("".join(look_up[ids]).split("|")).rstrip())
            texts.append(row)
        return {"labels": labels, "label_paddings": pads, "_transcripts": texts}


def make_dataset(cfg: DataConfig, sets: Sequence[str], batch_size: int, accum: int = 1,
                 shuffle: bool = True, seed: int = 0, host_id: int = 0, num_hosts: int = 1):
    """Rank ``host_id``'s stripe of the global batches of ``batch_size``."""
    if cfg.synthetic:
        return SyntheticDataset(cfg, batch_size, accum, seed, host_id, num_hosts)
    return BucketedLibriSpeech(cfg, sets, batch_size, accum, shuffle, seed, host_id, num_hosts)
