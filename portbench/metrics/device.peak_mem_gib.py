"""device.peak_mem_gib (GiB): torch.cuda.max_memory_allocated over the
run's set-up and window (reset at the start), before the reference runs.
None off a card."""


def read(run):
    if not run.peak_mem_bytes:
        return None
    return run.peak_mem_bytes / 2 ** 30
