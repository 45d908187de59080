"""setup_s (s, host clock): from the process start to the first timed call:
imports, the weights, the pool made and moved to the card, the system
built, the cell's shapes warmed up (the first run in a checkout also builds
the port's kernels), and with --trace 1 the work counts."""


def read(run):
    return run.setup_s
