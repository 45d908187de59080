"""mfu_pct (%): the model operations of the measured window's calls, counted
from the shapes and the pool's in-radius pairs (benchmark/work.py), over
the window's wall time at the card's f32 peak (67 TFLOP/s)."""


def read(run):
    return run.mfu_pct()
