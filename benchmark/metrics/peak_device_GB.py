"""peak_device_GB (GB, host clock): the allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
less the bytes the benchmark itself holds on the card: its frames, for
frames that live there, and the buffers of the check's sample."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return (run.peak_bytes - run.held_bytes) / 1e9
