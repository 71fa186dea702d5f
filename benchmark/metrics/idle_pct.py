"""The share of the profiled stretch that the card spends waiting on the
host or a sync: 100 x the idle gaps of 10 us or more (between the union
of its kernel, copy and set intervals) over the stretch's length. The
gaps under 10 us between dependent kernels are left out: they are the
card's own launch latency, and the profiler lengthens them by an amount
that differs from run to run (2-5% of a train cell's stretch)."""

MIN_GAP_NS = 10_000


def read(r):
    st = r.stretch
    waited = sum(s for bound, _n, s in st.idle_by_size((MIN_GAP_NS,)) if bound is None)
    return 100.0 * waited / st.window_s
