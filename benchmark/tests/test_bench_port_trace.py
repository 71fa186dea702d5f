"""The trace reduction: the union of overlapping kernel intervals, the
idle share, the gaps named by the host operation open in them, and the
kernel families matched by name."""

from benchmark import trace
from benchmark.trace import Record, Stretch


def test_union_of_overlapping_intervals():
    assert trace.union([(5, 9), (0, 3), (2, 4), (8, 12), (20, 21)]) == [(0, 4), (5, 12), (20, 21)]
    assert trace.union([(0, 10), (2, 3), (9, 15)]) == [(0, 15)]
    assert trace.gaps([(2, 4), (6, 8)], 0, 10) == [(0, 2), (4, 6), (8, 10)]


def test_idle_share_counts_overlaps_once():
    k = [Record("void a<1>(int)", 10, 40), Record("b(float)", 30, 50),  # overlap 30-40
         Record("void a<1>(int)", 60, 70)]
    host = [Record("bench.call", 0, 100), Record("aten::copy_", 45, 65)]
    st = Stretch(0, 100, k, k, host, {"void a<1>(int)": "fam"})
    assert st.busy_s == 50e-9  # 10-50 and 60-70
    assert abs(100 * (1 - st.busy_s / st.window_s) - 50.0) < 1e-9
    br = st.breakdown()
    assert br["device_ops"][0] == ["a<1>", 40e-9]
    # the longest gap 70-100 is in bench.call alone; 50-60 inside aten::copy_
    assert br["idle_gaps"][0] == ["bench.call", 30e-9]
    assert ["aten::copy_", 10e-9] in br["idle_gaps"]
    # gaps 0-10, 50-60 and 70-100 by length
    assert st.idle_by_size((20, 30)) == [[20, 2, 20e-9], [30, 0, 0.0], [None, 1, 30e-9]]
    assert [r.name for r in st.library()] == ["b(float)"]
    assert len(st.family("fam")) == 2


def test_family_names_match_whole_identifiers():
    assert trace.name_matches("flash_bwd_dq", "void flash_bwd_dq<40, true>(float const*)")
    assert not trace.name_matches("flash_bwd_dq", "flash_bwd_dq_sum(float const*, int)")
    assert trace.name_matches("gn_prefix_bf16", "gn_prefix_bf16(__nv_bfloat16 const*)")
    assert trace.short_name("void (anonymous namespace)::conv_layer_wgmma<false>(CUtensorMap)") \
        == "conv_layer_wgmma<false>"


def test_every_port_kernel_has_a_family():
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    names = trace.port_kernel_names(os.path.join(root, "fithubert_tpu_torch", "csrc"))
    assert "flash_fwd_wgmma" in names and "conv_layer_wgmma" in names
    mapped = {k for fam in trace.load_families().values() for k in fam["kernels"]}
    assert set(names) <= mapped
    st = Stretch(0, 10, [Record("void new_kernel<2>(int)", 1, 2)], [], [], {})
    assert st.unmapped(names + ["new_kernel"]) == ["void new_kernel<2>(int)"]


def test_idle_metric_counts_only_waits_of_10_us_or_more():
    from types import SimpleNamespace

    from benchmark import harness

    us = 1_000
    k = [Record("a(int)", 0, 100 * us), Record("a(int)", 101 * us, 200 * us),  # a 1-us gap
         Record("a(int)", 250 * us, 400 * us)]  # a 50-us wait
    st = Stretch(0, 500 * us, k, k, [], {})  # and 100 us at the end
    assert abs(harness.load_metric("idle_pct.train").read(SimpleNamespace(stretch=st)) - 30.0) < 1e-9


class _Event:
    """A kineto event as ``trace.from_profiler`` reads it."""

    def __init__(self, name, start, end, corr=0, cuda=False):
        self._name, self._start, self._end, self._corr, self._cuda = name, start, end, corr, cuda

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def device_type(self):
        from types import SimpleNamespace

        return SimpleNamespace(name="CUDA" if self._cuda else "CPU")

    def is_user_annotation(self):
        return False


def test_the_stretch_takes_in_the_work_its_calls_launched():
    fams = {"fam": {"kernels": ["a"]}}
    events = [_Event("cudaGraphLaunch", 40, 45, corr=3),  # the call before the stretch
              _Event("void a<1>(int)", 50, 90, corr=3, cuda=True),
              _Event("bench.call", 100, 200),
              _Event("aten::mm", 120, 130, corr=3),  # an op's id, not a launch's
              _Event("cudaGraphLaunch", 150, 155, corr=7),
              _Event("void a<1>(int)", 160, 205, corr=7, cuda=True),
              _Event("bench.sync", 200, 210),
              _Event("void a<1>(int)", 230, 240, corr=9, cuda=True)]  # launched after it
    st = trace.from_profiler(events, fams)
    assert (st.lo, st.hi) == (100, 210)
    assert [(r.start, r.end) for r in st.family("fam")] == [(160, 205)]
    # the device's clock puts a kernel of the stretch before its first span
    # and its last kernel past the sync that waited for it
    events += [_Event("cuLaunchKernel", 101, 102, corr=11),
               _Event("void a<1>(int)", 96, 104, corr=11, cuda=True),
               _Event("void a<1>(int)", 212, 220, corr=7, cuda=True)]
    st = trace.from_profiler(events, fams)
    assert (st.lo, st.hi) == (96, 220)
    assert sorted((r.start, r.end) for r in st.family("fam")) == [(96, 104), (160, 205),
                                                                   (212, 220)]
