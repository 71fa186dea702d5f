"""Device milliseconds per optimizer step (train) or served call (serve)
in the positional conv's kernels, the ``pos_conv`` family of ``kernels/``:
its forward and, in training, its input gradient. From the profiled
stretch's kernel records; None where the stretch ran none of them (a
program that runs the conv as a library call)."""

FAMILY = "pos_conv"


def read(r):
    if r.kind not in ("train", "serve") or not r.units:
        return None
    st = r.stretch
    launches = st.family(FAMILY)
    if not launches:
        return None
    ns = sum(min(k.end, st.hi) - max(k.start, st.lo) for k in launches)
    return ns / 1e6 / len(r.units)
