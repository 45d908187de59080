"""peak_mem_mib (MiB): torch.cuda.max_memory_allocated over the measured
window (reset after the warm-up)."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
