"""The port's data pipeline (fithubert_tpu_torch/data) against the JAX
package's on the same inputs: synthetic batches and bucketed batches of a
tiny on-disk corpus (FLACs from tests/flac_writer.py and a WAV), bit for
bit, including the CSV generation, a partial bucket's padding rows and the
fabricated microbatch of a trailing group; and what the port refuses."""

import csv
import os

import numpy as np
import pytest

from fithubert_tpu.config import DataConfig as JDataConfig
from fithubert_tpu.data import librispeech as jls
from fithubert_tpu_torch.config import DataConfig
from fithubert_tpu_torch.data import audio
from fithubert_tpu_torch.data import librispeech as ls
from fithubert_tpu_torch.export import expert
from tests.flac_writer import write_flac, write_wav

SMOKE_DATA = dict(synthetic=True, synthetic_num_batches=6, synthetic_wav_length=16000,
                  length_quantum=4000)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """LibriSpeech-shaped: <root>/train-tiny/<spk>/<chap>/<utt>.flac, eight
    utterances of ragged lengths, one of them a 16-bit WAV; no CSV."""
    root = tmp_path_factory.mktemp("librispeech")
    rng = np.random.default_rng(0)
    for u in range(8):
        chap = root / "train-tiny" / str(1 + u % 2) / "7"
        chap.mkdir(parents=True, exist_ok=True)
        n = 1500 + 613 * u
        sig = np.round(3000 * np.sin(np.arange(n) * 0.03 * (u + 1))
                       + 300 * rng.standard_normal(n)).astype(np.int64)
        name = f"{1 + u % 2}-7-{u:04d}"
        if u == 5:
            write_wav(str(chap / f"{name}.wav"), sig.astype(np.float32) / 32768.0)
        else:
            write_flac(str(chap / f"{name}.flac"), [sig], kind="fixed1" if u % 2 else "verbatim")
    return str(root)


def _configs(root, tmp_path, **kw):
    common = dict(libri_root=root, length_quantum=1000, num_workers=2, prefetch=1, **kw)
    return (JDataConfig(bucketing_path=str(tmp_path / "jax_csv"), **common),
            DataConfig(bucketing_path=str(tmp_path / "port_csv"), **common))


def test_synthetic_batches_bit_equal_to_jax():
    jd = jls.SyntheticDataset(JDataConfig(**SMOKE_DATA), batch_size=2, accum=2, seed=3)
    pd = ls.SyntheticDataset(DataConfig(**SMOKE_DATA), batch_size=2, accum=2, seed=3)
    assert len(pd) == len(jd) == 3
    for epoch in (0, 1):
        got, want = list(pd.epoch(epoch)), list(jd.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == {"x", "padding_mask"}
            np.testing.assert_array_equal(g["x"], w["x"])
            np.testing.assert_array_equal(g["padding_mask"], w["padding_mask"])


def test_bucketed_batches_bit_equal_to_jax(corpus, tmp_path):
    """batch 3 x accum 2 over 8 utterances: buckets of 3, 3 and 2 (the
    partial one padded with an all-padding row), and a trailing group
    squared off with a fabricated microbatch; shuffled per epoch."""
    jcfg, pcfg = _configs(corpus, tmp_path)
    jd = jls.BucketedLibriSpeech(jcfg, ["train-tiny"], batch_size=3, accum=2, seed=5)
    pd = ls.BucketedLibriSpeech(pcfg, ["train-tiny"], batch_size=3, accum=2, seed=5)
    with open(tmp_path / "jax_csv" / "train-tiny.csv") as f:
        want_rows = list(csv.reader(f))
    with open(tmp_path / "port_csv" / "train-tiny.csv") as f:
        assert list(csv.reader(f)) == want_rows
    assert len(want_rows) == 9  # header + 8 utterances, the WAV included
    assert pd.buckets == jd.buckets and len(pd) == len(jd) == 2
    fabricated = partial = 0
    for epoch in (0, 1):
        got, want = list(pd.epoch(epoch)), list(jd.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["x"].shape == w["x"].shape and g["x"].shape[:2] == (2, 3)
            assert g["x"].shape[2] % 1000 == 0
            np.testing.assert_array_equal(g["x"], w["x"])
            np.testing.assert_array_equal(g["padding_mask"], w["padding_mask"])
            rows_padded = g["padding_mask"].all(-1)
            fabricated += int(rows_padded.all(-1).sum())
            partial += int((rows_padded.sum(-1) == 1).sum())
    assert fabricated == 2 and partial == 2  # one of each per epoch


def test_bucketed_max_wav_length_crops_as_jax(corpus, tmp_path):
    jcfg, pcfg = _configs(corpus, tmp_path, max_wav_length=2500)
    jb = jls.BucketedLibriSpeech(jcfg, ["train-tiny"], batch_size=4, accum=1,
                                 shuffle=False).first_batch()
    pb = next(ls.BucketedLibriSpeech(pcfg, ["train-tiny"], batch_size=4, accum=1,
                                     shuffle=False).epoch(0))
    assert pb["x"].shape == (1, 4, 2500)
    np.testing.assert_array_equal(pb["x"], jb["x"])
    np.testing.assert_array_equal(pb["padding_mask"], jb["padding_mask"])


@pytest.mark.parametrize("length, quantum, max_length", [
    (1, 1000, 0), (1000, 1000, 0), (1001, 1000, 0), (4321, 1600, 0), (9000, 4000, 6000),
    (77, 1, 0), (163840, 40960, 0), (192001, 40960, 0)])
def test_quantize_length_is_one_copy_equal_to_jax(length, quantum, max_length):
    assert expert.quantize_length is ls.quantize_length
    assert ls.quantize_length(length, quantum, max_length) == \
        jls.quantize_length(length, quantum, max_length)


def test_make_buckets_drops_a_single_trailing_row_as_jax():
    rows = [(f"u{i}", 100 - i) for i in range(7)]
    for b in (2, 3, 6):
        assert ls.make_buckets(rows, b) == jls.make_buckets(rows, b)
    assert len(ls.make_buckets(rows, 3)) == 2  # 3 + 3, the seventh alone dropped


def test_native_decoder_matches_the_written_samples(corpus):
    """16-bit FLAC and WAV decode to int / 32768 exactly."""
    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(corpus) for f in fs
                   if f.endswith((".flac", ".wav")))
    wav = audio.decode(paths[0])
    batch, lengths = audio.decode_batch(paths, 6000)
    assert batch.shape == (8, 6000) and lengths.tolist() == [len(audio.decode(p))
                                                             for p in paths]
    np.testing.assert_array_equal(batch[0, : len(wav)], wav)
    assert not batch[0, len(wav):].any()
    assert np.all(np.abs(wav) <= 1.0) and np.all(wav * 32768.0 == np.round(wav * 32768.0))


def test_an_undecodable_file_raises_and_is_never_silence(tmp_path):
    """Where the JAX package skips a corrupt file in its scan, or decodes it
    to silence, the port raises and names the file."""
    chap = tmp_path / "train-bad" / "1" / "2"
    chap.mkdir(parents=True)
    write_flac(str(chap / "1-2-0000.flac"), [np.arange(3000, dtype=np.int64) % 200])
    bad = chap / "1-2-0001.wav"
    bad.write_bytes(b"RIFF\x00\x00")
    with pytest.raises(RuntimeError, match="1-2-0001.wav"):
        audio.decode(str(bad))
    with pytest.raises(RuntimeError, match="1-2-0001.wav"):
        audio.decode_batch([str(chap / "1-2-0000.flac"), str(bad)], 4000)
    with pytest.raises(RuntimeError, match="1-2-0001.wav"):
        ls.scan_split(str(tmp_path), "train-bad")
    with pytest.raises(ValueError, match="flac and .wav"):
        audio.decode(str(tmp_path / "x.mp3"))


def test_decoder_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(audio, "BUILD", str(tmp_path / "build"))
    audio._load_locked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building the audio decoder"):
            audio.load()
    finally:
        audio._load_locked.cache_clear()
    assert not any(f.endswith(".so") for _, _, fs in os.walk(tmp_path) for f in fs)


def test_missing_corpus_and_labels_raise(tmp_path):
    cfg = DataConfig(bucketing_path=str(tmp_path / "csv"), libri_root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="corpus not found"):
        ls.BucketedLibriSpeech(cfg, ["dev-clean"], batch_size=2)
    with pytest.raises(NotImplementedError, match="load_labels.*Queue 1 item 6"):
        ls.make_dataset(DataConfig(synthetic=True, load_labels=True), ["x"], 2)
