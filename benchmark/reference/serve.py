"""The reference's served features: the utterances of one call padded with
zeros to a multiple of the length quantum (a frozen copy of the program's
``quantize_length``), the student's deterministic forward of the
configuration's reference module (``load``) in blocks of rows, and what
an s3prl upstream returns: the last hidden state, each
layer's hidden state and the frame padding mask."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import load


def quantize_length(length: int, quantum: int, max_length: int = 0) -> int:
    q = ((length + quantum - 1) // quantum) * quantum if quantum > 1 else length
    if max_length > 0:
        q = min(q, max_length)
    return max(q, quantum if quantum > 1 else length)


def features(cfg: Dict, student: Dict[str, torch.Tensor], wavs: Sequence[np.ndarray],
             quantum: int, device, quant: str = "fp32", rows: int = 8) -> Dict[str, object]:
    model = load(cfg)
    q = model.QUANT[quant]
    d = cfg["experiment"]["distiller"]
    params = {k: v.float() for k, v in student.items()}
    t_pad = quantize_length(max(len(w) for w in wavs), quantum)
    batch = np.zeros((len(wavs), t_pad), np.float32)
    mask = np.ones((len(wavs), t_pad), bool)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
        mask[i, : len(w)] = False
    outs = []
    with torch.no_grad():
        for r0 in range(0, len(wavs), rows):
            x = torch.from_numpy(batch[r0:r0 + rows]).to(device)
            m = torch.from_numpy(mask[r0:r0 + rows]).to(device)
            outs.append(model.student_forward(params, d, x, m, None, q, export=True))
    return {"last_hidden_state": torch.cat([o["x"] for o in outs]),
            "hidden_states": tuple(torch.cat([o["hiddens"][i] for o in outs])
                                   for i in range(len(outs[0]["hiddens"]))),
            "padding_mask": torch.cat([o["mask"] for o in outs])}
