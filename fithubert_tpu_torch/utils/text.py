"""Letter vocabulary, greedy CTC decoding, and WER/CER metrics: the port's
copy of ``fithubert_tpu/utils/text.py``.

Parity targets (reference utils/utils.py:23-48 + dict.ltr.txt): the fairseq
letter dictionary (4 specials + 28 letter symbols, frequency-ordered),
`Decoder.decode` (group consecutive ids, drop '<s>' as CTC blank, '|' is the
word separator), and `CTCSequenceConverter` (collapse duplicates, remove
blanks). The reference references WER/CER metrics that were never initialized
(SURVEY.md §4 — its non-task-agnostic path cannot run); here they are
implemented and working.
"""

from __future__ import annotations

import os
from itertools import groupby
from typing import Dict, List, Sequence

import numpy as np

# fairseq letter-dict order: 4 specials then symbols by corpus frequency
# (reference utils/utils.py:25-28; dict.ltr.txt holds the non-special rows).
SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
LETTERS = (
    "|", "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U", "M",
    "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X", "J", "Q", "Z",
)

BLANK_ID = 0  # '<s>' doubles as the CTC blank (reference utils/utils.py:36,47)


class LetterDictionary:
    """sym <-> id mapping over SPECIALS + letter file rows."""

    def __init__(self, symbols: Sequence[str] = SPECIALS + LETTERS):
        self.symbols: List[str] = list(symbols)
        self.indices: Dict[str, int] = {s: i for i, s in enumerate(self.symbols)}
        self.look_up = np.asarray(self.symbols)

    @classmethod
    def load(cls, path: str) -> "LetterDictionary":
        """Read a fairseq 'SYMBOL COUNT' letter dict file (e.g. dict.ltr.txt)."""
        syms = list(SPECIALS)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    syms.append(line.split()[0])
        return cls(syms)

    def __len__(self) -> int:
        return len(self.symbols)

    def encode(self, text: str) -> List[int]:
        """Transcript -> letter ids; spaces become '|' (fairseq ltr format)."""
        chars = list(text.strip().upper().replace(" ", "|"))
        unk = self.indices["<unk>"]
        return [self.indices.get(c, unk) for c in chars]


class GreedyCTCDecoder:
    """argmax-id sequence -> text (reference Decoder, utils/utils.py:23-37)."""

    def __init__(self, dictionary: LetterDictionary | None = None):
        self.dictionary = dictionary or LetterDictionary()
        self.look_up = self.dictionary.look_up

    def decode(self, ids: Sequence[int]) -> str:
        toks = self.look_up[np.asarray(ids, dtype=np.int64)]
        fused = [t for t, _ in groupby(toks)]
        joined = "".join(fused)
        # drop blanks, map word separators to spaces (reference :36)
        return " ".join("".join(joined.split("<s>")).split("|")).rstrip()


def ctc_collapse(ids: Sequence[int], blank: int = BLANK_ID) -> List[int]:
    """Collapse duplicates and remove blanks (reference CTCSequenceConverter,
    utils/utils.py:40-48)."""
    return [t for t, _ in groupby(ids) if t != blank]


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (two-row DP)."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i]
        for j, h in enumerate(hyp, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h)))
        prev = cur
    return prev[-1]


def wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus-level word error rate."""
    errs = total = 0
    for ref, hyp in zip(references, hypotheses):
        rw, hw = ref.split(), hyp.split()
        errs += edit_distance(rw, hw)
        total += len(rw)
    return errs / max(total, 1)


def cer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus-level character error rate (spaces included, like evaluate's cer)."""
    errs = total = 0
    for ref, hyp in zip(references, hypotheses):
        errs += edit_distance(list(ref), list(hyp))
        total += len(ref)
    return errs / max(total, 1)


def edit_stats(references: Sequence[str], hypotheses: Sequence[str]):
    """(word errs, words, char errs, chars) — summable across hosts so a
    multi-host eval can aggregate to one corpus-level WER/CER."""
    w_err = w_tot = c_err = c_tot = 0
    for ref, hyp in zip(references, hypotheses):
        w_err += edit_distance(ref.split(), hyp.split())
        w_tot += len(ref.split())
        c_err += edit_distance(list(ref), list(hyp))
        c_tot += len(ref)
    return w_err, w_tot, c_err, c_tot


def default_dict_path() -> str:
    """``data/dict.ltr.txt`` at the root of the repository."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "data", "dict.ltr.txt",
    )
