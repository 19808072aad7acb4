"""The trace's reduction: device busy and idle time, kernel time by name,
spans, and the breakdown, from kineto-like events."""
from portbench import trace

MS = 1_000_000  # ns


class Ev:
    def __init__(self, name, kind, start_ms, dur_ms, cuda):
        self._n, self._k, self._s, self._d, self._c = name, kind, start_ms, dur_ms, cuda

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * MS)

    def duration_ns(self):
        return int(self._d * MS)


class NoKind(Ev):
    """An event of a torch without ``activity_type``."""
    activity_type = None


EVENTS = [
    Ev("pb.request", "user_annotation", 0, 10, False),
    Ev("pb.sampler_call", "user_annotation", 0, 6, False),
    Ev("pb.copy_to_host", "user_annotation", 6, 4, False),
    Ev("pb.request", "gpu_user_annotation", 0, 10, True),
    Ev("void dense_gn_silu_wgmma_kernel<64, true>(Params)", "kernel", 1, 3, True),
    Ev("void head_em_kernel<4>(Params)", "kernel", 4, 1, True),
    Ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 8, 1, True),
    Ev("cudaStreamSynchronize", "cuda_runtime", 7, 2, False),
    Ev("void dense_gn_silu_wgmma_kernel<64, true>(Params)", "kernel", 12, 3, True),  # after
]


def check(tr):
    assert tr.window_s == 0.010
    assert abs(tr.busy_s - 0.005) < 1e-12
    assert abs(tr.op_seconds(r"\bdense_gn_silu(_wgmma)?_kernel\b") - 0.003) < 1e-12
    assert ("request", 0.0, 0.010) in tr.spans
    gaps = tr.idle_gaps()
    assert [round(e - s, 6) for s, e in gaps] == [0.001, 0.003, 0.001]
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "dense_gn_silu_wgmma_kernel"
    idle = dict(b["idle_gaps"])
    assert abs(idle["sampler_call"] - 0.004) < 1e-12 and abs(idle["copy_to_host"] - 0.001) < 1e-12


def test_reduce():
    check(trace.reduce_events(EVENTS, (0, 10 * MS)))


def test_reduce_without_activity_types():
    check(trace.reduce_events([NoKind(e._n, None, e._s, e._d, e._c) for e in EVENTS],
                              (0, 10 * MS)))


def test_short_name():
    assert trace.short_name("void dposer::head_em_kernel<4, true>(Params const&)") == \
        "head_em_kernel"
    assert trace.short_name("void (anonymous namespace)::dense_gn_silu_bwd_kernel<32, "
                            "dposer::wgss::Ring<1, 4> >(CUtensorMap_st)") == \
        "dense_gn_silu_bwd_kernel"
    assert trace.short_name("void at::native::f<at::G*, {lambda(unsigned long)#1}>"
                            "(at::T&, {lambda()#4})") == "f"


def test_busy_seconds():
    # the device's operations only (a record of the device's activity alone
    # holds no spans), overlaps merged: kernels at 1-4 and 4-5, the copy at
    # 8-9 and the kernel at 12-15 ms
    device_only = [e for e in EVENTS if not e.name().startswith(trace.PREFIX)]
    assert abs(trace.busy_seconds(device_only) - 0.008) < 1e-12
    overlapping = [Ev("k", "kernel", 0, 5, True), Ev("k", "kernel", 2, 2, True),
                   Ev("k", "kernel", 4, 3, True)]
    assert abs(trace.busy_seconds(overlapping) - 0.007) < 1e-12
    assert trace.busy_seconds([]) == 0.0
