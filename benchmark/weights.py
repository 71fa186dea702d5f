"""Weights and audio drawn from the run's seed on the device, in a few
large calls: every normal leaf from one ``randn``, every uniform leaf from
one ``rand``, at the scales of the leaves' specs, which the configuration's
reference module gives (``reference.load``). ``reference/model.py``'s are a
frozen copy of the port's ``models/student.py init_parameters``, which the
teacher shares: extractor convs kaiming normal, Linear layers normal at
0.02 inside the encoder and fan_in^-0.5 elsewhere with zero bias, the TR
conv and upsampler torch's uniform conv init, the weight-normed positional
conv's v normal at sqrt(4 / (k e)) and g at that times sqrt(e^2 / groups),
the SplitLinear head uniform at in_dim^-0.5, norms at one and zero. The
same dict goes to the program and to the reference."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import reference

TAGS = {"teacher": 1, "student": 2, "audio": 3}


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + TAGS[tag]) % (1 << 63))


def draw(spec: reference.Spec, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """fp32 leaves of ``spec`` (key, shape, kind, scale)."""
    out: Dict[str, torch.Tensor] = {}
    for kind, fn in (("normal", lambda n: torch.randn(n, generator=gen, device=device)),
                     ("uniform", lambda n: torch.rand(n, generator=gen, device=device) * 2 - 1)):
        leaves: List[Tuple[str, Tuple[int, ...], float]] = [
            (k, shape, scale) for k, shape, kd, scale in spec if kd == kind]
        total = sum(torch.Size(s).numel() for _k, s, _c in leaves)
        buf = fn(total) if total else None
        at = 0
        for k, shape, scale in leaves:
            n = torch.Size(shape).numel()
            out[k] = (buf[at:at + n] * scale).view(shape)
            at += n
    for k, shape, kind, scale in spec:
        if kind == "fill":
            out[k] = torch.full(shape, float(scale), device=device)
    return {k: out[k] for k, *_ in spec}


def teacher_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw(reference.load(cfg).teacher_spec(cfg["teacher_geometry"]),
                generator(seed, "teacher", device), device)


def student_state(cfg: Dict, seed: int, device, export: bool = False) -> Dict[str, torch.Tensor]:
    return draw(reference.load(cfg).student_spec(cfg["experiment"]["distiller"], export),
                generator(seed, "student", device), device)


def waveforms(lengths, t_pad: int, amplitude: float, gen: torch.Generator, device,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, t_pad) noise cut to each length, zero past it, and the padding
    mask (True = padding)."""
    n = len(lengths)
    x = torch.randn((n, t_pad), generator=gen, device=device) * amplitude
    lens = torch.tensor(lengths, device=device)
    mask = torch.arange(t_pad, device=device)[None, :] >= lens[:, None]
    return x.masked_fill(mask, 0.0), mask
