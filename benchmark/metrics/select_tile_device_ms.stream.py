"""select_tile_device_ms (ms/call, program span): the device time of the work
launched inside the port's deepvcp.select_tile spans, per traced call
(spans.census). ops/knn.py::select opens one such span around each call of
K6's bf16 arm (a selection on the bf16 tile, as lidar-fine's: centring,
norms, the kernel's launch and the sort), and, off K6's domain (k > 32, as
two-level's level 1; f16; N > 65 536; the CPU), one around each query chunk
of the plain tile (the distance tile, in the selection dtype, and
torch.topk). K6's f32 arm opens none. None where the program opens no such
span or the spans launched nothing on the device."""

from benchmark import spans

SPAN = spans.PREFIX + "select_tile"


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    row = spans.census(run.trace).get(SPAN)
    return row["device_ms"] if row and row["device_ms"] > 0 else None
