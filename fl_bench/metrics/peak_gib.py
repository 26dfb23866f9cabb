"""Peak device memory over the timed window (``torch.cuda.
max_memory_allocated`` after a reset at its start), in GiB."""


def read(run):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
