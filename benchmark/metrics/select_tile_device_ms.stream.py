"""select_tile_device_ms (ms/call, program span): the device time of the work
launched inside the port's deepvcp.select_tile spans (ops/knn.py approx_knn's
tile arm: each query chunk's distance product, combination, cast and
torch.topk), per traced call (spans.census). None where the program opens no
such span (the kernel K6 arm, or a program without the span) or the spans
launched nothing on the device."""

from benchmark import spans

SPAN = spans.PREFIX + "select_tile"


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    row = spans.census(run.trace).get(SPAN)
    return row["device_ms"] if row and row["device_ms"] > 0 else None
