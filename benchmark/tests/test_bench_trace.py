"""The trace reduction on a hand-made trace: the union, the idle gaps and
their labels, a range's device time through the launch's correlation id, the
syncs and the kernels by name."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from benchmark.trace import Trace


class Event:
    def __init__(self, name, start, end, device=False, annotation=False, corr=0, linked=0):
        self._v = (name, start, end, device, annotation, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def make_trace():
    events = [
        Event("bench.window", 0, 1000, annotation=True),
        Event("bench.encode", 10, 200, annotation=True),
        Event("bench.correspond", 300, 700, annotation=True),
        Event("bench.candidate_neighbors", 320, 500, annotation=True),
        Event("bench.encode", 0, 1000, device=True, annotation=True),   # device-side range
        Event("cudaLaunchKernel", 20, 25, corr=1),
        Event("cudaLaunchKernel", 330, 335, corr=2),
        Event("cudaLaunchKernel", 600, 605, corr=3),
        Event("cudaStreamSynchronize", 605, 900, corr=4),
        Event("aten::linalg_svd", 590, 910),
        Event("void band_max_kernel<16, 4>(float const*)", 30, 130, device=True, corr=1),
        Event("void knn_tile()", 340, 540, device=True, linked=2),
        Event("void softmax()", 620, 700, device=True, corr=3),
        Event("void band_max_grad_kernel<16>(float const*)", 1500, 1600, device=True, corr=9),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return Trace(prof, calls=2)


def test_union_and_idle():
    t = make_trace()
    assert t.busy_ns == 100 + 200 + 80 and t.window_s == 1000 / 1e9
    assert abs(t.idle_share() - (1 - 380 / 1000)) < 1e-12
    assert t.gaps == [(0, 30), (130, 340), (540, 620), (700, 1000)]


def test_ranges_kernels_syncs():
    t = make_trace()
    assert t.range_device_ms("encode") == 100 / 1e6
    assert t.range_device_ms("correspond") == (200 + 80) / 1e6
    assert t.range_device_ms("candidate_neighbors") == 200 / 1e6
    assert t.range_device_ms("missing") is None
    assert t.kernel_ms("band_max_kernel<") == 100 / 1e6
    assert t.syncs == 1 and t.unlinked == 0


def test_breakdown_labels_gaps():
    b = make_trace().breakdown()
    assert b["device_ops"][0] == ["void knn_tile()", 200 / 1e9]
    longest = b["idle_gaps"][0]
    assert longest[1] == 300 / 1e9 and longest[0] == "window/cudaStreamSynchronize"
    assert [g[0] for g in b["idle_gaps"][1:]] == ["window/python", "correspond/python",
                                                  "encode/python"]
