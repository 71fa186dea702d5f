"""Host ms a served call spends inside the kernel wrappers' spans: each
launch's checks, allocations, tensor maps and the launch, in a span named
after its launch counter (the ``launch_counters`` of ``kernels/``). Part of
the host time in ``expert.model``, printed beside it."""

import sys

from benchmark import program


def read(r):
    if r.kind != "serve":
        return None
    ms = program.launch_spans(r.stretch)
    if ms is not None:
        print(f"expert.model: {program.span_ms(r.stretch, ['expert.model'])!r} host ms a call, "
              f"{ms!r} of them in the kernel wrappers", file=sys.stderr)
    return ms
