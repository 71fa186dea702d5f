"""Features of audio files from a trained student, one ``.npy`` each: the
counterpart of ``scripts/extract_features.py``.

    python -m fithubert_tpu_torch.export.extract_features \\
        --ckpt results/pretrain/run/student.pt --config results/pretrain/run/student.yaml \\
        --inputs path/to/*.flac --out feats/ [--layer N] [--batch-size 8] [--device cuda]

``--ckpt`` takes the port's export or the reference's Lightning ``.ckpt``.
Each input gives ``<out>/<name>.npy`` of shape (frames, D) in float32:
``last_hidden_state`` at 50 Hz, or ``hidden_states[N]`` with ``--layer N``,
cropped to the utterance's frames by the model's padding mask (kept at the
post-TR rate, so its count is scaled to the output's rate). Inputs that
share a file name get ``<name>.1``, ``<name>.2``, ... in order. Audio is
decoded by ``data/audio.py``; ``--device`` is ``cuda`` (the default) or
``cpu``; ``--int8`` serves with int8 matmuls (``UpstreamExpert(int8=True)``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def output_names(paths: Sequence[str]) -> Dict[str, str]:
    """A unique output name per input: its base name, with ``.1``, ``.2``,
    ... for later inputs of the same base name."""
    names, seen = {}, {}
    for p in paths:
        base = os.path.splitext(os.path.basename(p))[0]
        n = seen.get(base, 0)
        seen[base] = n + 1
        names[p] = base if n == 0 else f"{base}.{n}"
    return names


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    """Write the features; returns {output name: frames}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="student.pt export or reference .ckpt")
    ap.add_argument("--config", required=True, help="dumped student yaml")
    ap.add_argument("--inputs", nargs="+", required=True, help="audio files (.flac/.wav)")
    ap.add_argument("--out", required=True, help="output directory for .npy")
    ap.add_argument("--layer", type=int, default=-1,
                    help="hidden_states index to dump (-1 = last_hidden_state)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--int8", action="store_true", help="int8 matmuls (ops/quant.py)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from fithubert_tpu_torch.data import audio
    from fithubert_tpu_torch.export.expert import UpstreamExpert

    expert = UpstreamExpert(args.ckpt, args.config, device=args.device, int8=args.int8)
    os.makedirs(args.out, exist_ok=True)
    names = output_names(args.inputs)
    frames = {}
    for i in range(0, len(args.inputs), args.batch_size):
        paths = args.inputs[i: i + args.batch_size]
        out = expert([audio.decode(p) for p in paths])
        feats = out["last_hidden_state"] if args.layer < 0 else out["hidden_states"][args.layer]
        pad = out["padding_mask"]
        factor = feats.shape[1] // pad.shape[1] if feats.shape[1] % pad.shape[1] == 0 else 0
        for j, p in enumerate(paths):
            n = int((~pad[j]).sum()) * factor if factor else feats.shape[1]
            frames[names[p]] = n
            np.save(os.path.join(args.out, names[p] + ".npy"),
                    feats[j, :n].float().cpu().numpy())
        print(f"[extract] {min(i + args.batch_size, len(args.inputs))}/{len(args.inputs)}",
              flush=True)
    return frames


if __name__ == "__main__":
    main()
