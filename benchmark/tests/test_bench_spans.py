"""The program's spans (benchmark/spans.py) and the readers of the metrics
that read them, on a hand-made trace (as test_bench_trace.py builds one),
and a traced CPU run of a call cell and a stream cell."""

from types import SimpleNamespace

import pytest

from benchmark import manifest, spans
from benchmark.tests.helpers import cpu_run
from benchmark.tests.test_bench_trace import Event
from benchmark.trace import Trace

CALLS = 2
NEW = {"kitti25-rot.pair-b1": ("solve_syncs.pair", "solve_idle_ms.pair", "host_issue_ms.pair",
                               "host_wait_ms.pair"),
       "kitti25-rot.stream-b8": ("host_issue_ms.stream", "host_wait_ms.stream",
                                 "drain_wait_ms.stream")}


def trace_of(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return Trace(prof, calls=CALLS)


def make_trace():
    """One register span (10-600) with a solve span (300-500) in it; a
    drain span (700-800) after it. In the register, outside the solve: a
    launch, a sync (150-170) and a copy from card to card (200-205, no
    wait). In the solve, under aten::linalg_svd: a launch, a copy to pageable
    host memory (330-390, the host waits in it) and a sync (392-400), then a
    launch at 450. In the drain: a pageable copy (705-780) and a sync
    (782-790). The device: 110-160, the copy 210-212, 326-381, the copy
    381-385, 460-700 (launched in the solve), the copy 770-772."""
    return trace_of([
        Event("bench.window", 0, 1000, annotation=True),
        Event("deepvcp.register", 10, 600, annotation=True),
        Event("deepvcp.solve", 300, 500, annotation=True),
        Event("deepvcp.drain", 700, 800, annotation=True),
        Event("aten::linalg_svd", 310, 480),
        Event("cudaLaunchKernel", 100, 105, corr=1),
        Event("cudaStreamSynchronize", 150, 170, corr=2),
        Event("cudaMemcpyAsync", 200, 205, corr=3),
        Event("cudaLaunchKernel", 320, 325, corr=4),
        Event("cudaMemcpyAsync", 330, 390, corr=5),
        Event("cudaStreamSynchronize", 392, 400, corr=6),
        Event("cudaLaunchKernel", 450, 455, corr=7),
        Event("cudaMemcpyAsync", 705, 780, corr=8),
        Event("cudaStreamSynchronize", 782, 790, corr=9),
        Event("void a()", 110, 160, device=True, corr=1),
        Event("Memcpy DtoD (Device -> Device)", 210, 212, device=True, corr=3),
        Event("void svd()", 326, 381, device=True, corr=4),
        Event("Memcpy DtoH (Device -> Pageable)", 381, 385, device=True, corr=5),
        Event("void c()", 460, 700, device=True, corr=7),
        Event("Memcpy DtoH (Device -> Pageable)", 770, 772, device=True, corr=8),
    ])


def read(name, trace):
    return manifest.reader(name)(SimpleNamespace(trace=trace))


def test_solve_sync_counts_in_solve_and_register():
    t = make_trace()
    sp = spans.Spans(t)
    assert sp.sync_count(spans.SOLVE) == 1 and sp.sync_count(spans.REGISTER) == 2
    assert read("solve_syncs.pair", t) == 1 / CALLS
    assert t.syncs == 3   # host_syncs counts every sync of the window, as before


def test_issue_is_span_time_less_wait_time():
    t = make_trace()
    # the syncs and the pageable copy; the copy between card buffers is issue
    assert read("host_wait_ms.pair", t) == pytest.approx((20 + 60 + 8) / 1e6 / CALLS)
    assert read("host_issue_ms.pair", t) == pytest.approx((590 - 88) / 1e6 / CALLS)
    assert read("host_issue_ms.stream", t) == read("host_issue_ms.pair", t)
    assert read("host_wait_ms.stream", t) == read("host_wait_ms.pair", t)


def test_solve_idle_counts_the_gap_its_sync_returned_in():
    t = make_trace()
    assert t.gaps == [(0, 110), (160, 210), (212, 326), (385, 460), (700, 770), (772, 1000)]
    # 0-110 follows a launch; 160-210 holds the register's own sync's return
    assert read("solve_idle_ms.pair", t) == pytest.approx(75 / 1e6 / CALLS)


def test_drain_waits_apart_from_register_waits():
    t = make_trace()
    assert read("drain_wait_ms.stream", t) == pytest.approx((75 + 8) / 1e6 / CALLS)
    assert read("host_wait_ms.stream", t) == pytest.approx(88 / 1e6 / CALLS)


def test_census_sync_sites_and_runtime_calls():
    t = make_trace()
    c = spans.census(t)
    ms = 1e6 * CALLS
    assert c["deepvcp.register"] == pytest.approx({
        "n": 1 / CALLS, "host_ms": 590 / ms, "self_ms": 390 / ms, "syncs": 2 / CALLS,
        "wait_ms": 88 / ms, "launches": 3 / CALLS, "device_ms": (50 + 2 + 55 + 4 + 240) / ms,
        "idle_ms": (110 + 50 + 114) / ms})
    assert c["deepvcp.solve"] == pytest.approx({
        "n": 1 / CALLS, "host_ms": 200 / ms, "self_ms": 200 / ms, "syncs": 1 / CALLS,
        "wait_ms": 68 / ms, "launches": 2 / CALLS, "device_ms": (55 + 4 + 240) / ms,
        "idle_ms": 75 / ms})
    assert c["deepvcp.drain"]["syncs"] == 1 / CALLS
    assert c["deepvcp.drain"]["idle_ms"] == pytest.approx(70 / ms)
    assert c[spans.OUTSIDE]["idle_ms"] == pytest.approx(228 / ms)
    assert spans.sync_sites(t) == {
        ("deepvcp.register", spans.OUTSIDE, spans.OUTSIDE): 1 / CALLS,
        ("deepvcp.solve", "aten::linalg_svd", "aten::linalg_svd"): 1 / CALLS,
        ("deepvcp.drain", spans.OUTSIDE, spans.OUTSIDE): 1 / CALLS}
    calls = spans.runtime_calls(t)
    assert list(calls)[0] == ("deepvcp.drain", "cudaMemcpyAsync [Memcpy DtoH (Device -> Pageable)]")
    assert calls[("deepvcp.solve", "cudaMemcpyAsync [Memcpy DtoH (Device -> Pageable)]")] == \
        pytest.approx((1 / CALLS, 60 / ms, 60 / 1e6))


@pytest.mark.parametrize("name", sorted({n for names in NEW.values() for n in names}))
def test_readers_none_without_program_spans(name):
    t = trace_of([Event("bench.window", 0, 1000, annotation=True),
                  Event("cudaStreamSynchronize", 10, 20)])
    assert read(name, t) is None and read(name, None) is None


def test_manifest_meets_contract():
    assert manifest.problems(manifest.load()) == []


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_the_new_metrics(cell):
    res = cpu_run(cell, trace=True)
    assert res["correct"]
    reported = {m["name"] for m in manifest.reported(manifest.load(), cell)["per_layer"]}
    assert set(NEW[cell]) <= reported and set(NEW[cell]) <= set(res["metrics"])
    for name in NEW[cell]:
        if "wait" in name or "syncs" in name or "idle" in name:
            assert res["metrics"][name]["value"] == 0.0   # no CUDA sync on the CPU
    issue = res["metrics"][NEW[cell][2] if cell.endswith("pair-b1") else NEW[cell][0]]
    assert issue["value"] > 0 and issue["unit"] == "ms/call"
