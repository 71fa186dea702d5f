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
epoch)``, and decoded ahead on a thread pool. One process reads the whole
batch (the port has no data parallelism yet). Transcripts are not read:
``load_labels`` is refused until CTC is ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import os
import queue
import uuid
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from fithubert_tpu_torch.config import DataConfig
from fithubert_tpu_torch.data import audio

Batch = Dict[str, np.ndarray]


def _refuse_labels(cfg: DataConfig) -> None:
    if cfg.load_labels:
        raise NotImplementedError("data.load_labels: the PyTorch port reads no transcripts "
                                  "yet (ROADMAP Queue 1 item 6, CTC)")


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
    """Step batches of padded waveforms over the buckets of ``sets``."""

    def __init__(self, cfg: DataConfig, sets: Sequence[str], batch_size: int, accum: int = 1,
                 shuffle: bool = True, seed: int = 0):
        _refuse_labels(cfg)
        self.cfg = cfg
        self.batch_size = batch_size
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

    def _load_bucket(self, bucket, t_pad: int) -> Tuple[np.ndarray, np.ndarray]:
        b = len(bucket)
        x = np.zeros((self.batch_size, t_pad), np.float32)
        mask = np.ones((self.batch_size, t_pad), bool)
        paths = [os.path.join(self.cfg.libri_root, p) for (p, _n) in bucket]
        x[:b], lengths = audio.decode_batch(paths, t_pad, self.cfg.num_workers)
        for i in range(b):
            n = int(lengths[i])
            if 0 < self.cfg.max_wav_length < n:
                n = self.cfg.max_wav_length
                x[i, n:] = 0.0
            mask[i, :n] = False
        return x, mask

    def _build_group(self, group) -> Batch:
        """One accumulation group of bucket indices -> an (A, B, T) batch;
        index -1 is a fabricated all-padding microbatch."""
        bs = [self.buckets[int(g)] if int(g) >= 0 else [] for g in group]
        t_pad = max(quantize_length(max(n for (_p, n) in b), self.cfg.length_quantum,
                                    self.cfg.max_wav_length) for b in bs if b)
        loaded = [self._load_bucket(b, t_pad) for b in bs]
        return {"x": np.stack([l[0] for l in loaded]),
                "padding_mask": np.stack([l[1] for l in loaded])}

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
    lengths in [0.8 T, T]."""

    def __init__(self, cfg: DataConfig, batch_size: int, accum: int = 1, seed: int = 0):
        _refuse_labels(cfg)
        self.cfg = cfg
        self.batch_size = batch_size
        self.accum = max(1, accum)
        self.seed = seed

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
            yield {"x": np.where(mask, 0.0, x).astype(np.float32), "padding_mask": mask}


def make_dataset(cfg: DataConfig, sets: Sequence[str], batch_size: int, accum: int = 1,
                 shuffle: bool = True, seed: int = 0):
    if cfg.synthetic:
        return SyntheticDataset(cfg, batch_size, accum, seed)
    return BucketedLibriSpeech(cfg, sets, batch_size, accum, shuffle, seed)
