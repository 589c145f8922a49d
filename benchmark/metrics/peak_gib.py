"""peak_gib: torch.cuda.max_memory_allocated() over set-up and window, in
GiB: the device memory a user must have."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
