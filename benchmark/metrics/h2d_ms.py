"""Host ms a served call spends in the program's ``expert.h2d`` span
(``UpstreamExpert.forward``: the padded batch and mask copied from pageable
host memory to the card), over the profiled stretch's calls."""

from benchmark import program


def read(r):
    return program.span_ms(r.stretch, ["expert.h2d"]) if r.kind == "serve" else None
