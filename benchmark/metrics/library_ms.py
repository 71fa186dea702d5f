"""Device milliseconds per optimizer step (train) or served call (serve)
in kernels that no file of ``kernels/`` maps, the ones not built from the
program's csrc/: cuBLAS, cuDNN, PyTorch's elementwise passes and
reductions, AdamW. From the profiled stretch's kernel records."""


def read(r):
    if not r.units:
        return None
    st = r.stretch
    ns = sum(min(k.end, st.hi) - max(k.start, st.lo) for k in st.library())
    return ns / 1e6 / len(r.units)
