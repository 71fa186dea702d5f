"""Host ms a served call spends in the program's ``expert.pad`` span
(``UpstreamExpert.forward``: the waveforms to numpy, the zero-filled batch,
the row fills and the mask), over the profiled stretch's calls."""

from benchmark import program


def read(r):
    return program.span_ms(r.stretch, ["expert.pad"]) if r.kind == "serve" else None
