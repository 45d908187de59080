"""pairs_per_s (pairs/s, host clock): the pairs whose pose reached the host
within the measured window, over the time from the window's start until the
last of them landed ("stream" traffic only). Calls land whole, B pairs at a
time; over the window's own length the rate would move in steps of
B / seconds (1.3% at 62 pairs/s in 10 s)."""


def read(run):
    if run.traffic["entry"] != "stream" or not run.window.calls:
        return None
    return run.batch * len(run.window.calls) / run.window.wall_s
