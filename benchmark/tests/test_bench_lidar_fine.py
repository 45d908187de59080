"""The lidar-fine configuration and its cell: the manifest still meets the
contract, the cut cell runs through the harness on the CPU with `correct`
true, and select_tile_device_ms reads the device time launched inside the
program's deepvcp.select_tile spans, and nothing where there are none."""

from benchmark import manifest
from benchmark.tests.helpers import cpu_run
from benchmark.tests.test_bench_spans import CALLS, read, trace_of
from benchmark.tests.test_bench_trace import Event

CELL = "lidar-fine.stream-b8-1m"
METRIC = "select_tile_device_ms.stream"


def test_manifest_meets_contract():
    assert manifest.problems(manifest.load()) == []


def test_cell_runs_correct_on_cpu():
    res = cpu_run(CELL, trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    reported = {m["name"] for m in manifest.reported(manifest.load(), CELL)["per_layer"]}
    assert METRIC in reported
    assert METRIC not in res["metrics"]   # the spans launch no device work on the CPU


def test_select_tile_reads_the_device_time_launched_in_its_spans():
    """Two select_tile spans in a register span; kernels launched in them
    run 100 and 50 ns, one launched outside them 40 ns."""
    t = trace_of([
        Event("bench.window", 0, 1000, annotation=True),
        Event("deepvcp.register", 10, 900, annotation=True),
        Event("deepvcp.select_tile", 100, 200, annotation=True),
        Event("deepvcp.select_tile", 300, 400, annotation=True),
        Event("cudaLaunchKernel", 110, 115, corr=1),
        Event("cudaLaunchKernel", 310, 315, corr=2),
        Event("cudaLaunchKernel", 500, 505, corr=3),
        Event("void tile()", 120, 220, device=True, corr=1),
        Event("void topk()", 320, 370, device=True, corr=2),
        Event("void other()", 510, 550, device=True, corr=3),
    ])
    assert read(METRIC, t) == 150 / 1e6 / CALLS
    without = trace_of([
        Event("bench.window", 0, 1000, annotation=True),
        Event("deepvcp.register", 10, 900, annotation=True),
        Event("cudaLaunchKernel", 110, 115, corr=1),
        Event("void tile()", 120, 220, device=True, corr=1),
    ])
    assert read(METRIC, without) is None and read(METRIC, None) is None
