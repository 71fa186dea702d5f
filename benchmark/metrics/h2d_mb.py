"""MB a served call hands from host memory to the card: the program's
``h2d_bytes`` counter's change over the profiled stretch, over its calls
(32 rows x the padded length x (4 + 1) B: the fp32 batch and the bool
mask)."""

from benchmark import program


def read(r):
    if r.kind != "serve":
        return None
    n, calls = program.counted(r.stretch, "h2d_bytes"), program.calls(r.stretch)
    return n / calls / 1e6 if n is not None and calls else None
