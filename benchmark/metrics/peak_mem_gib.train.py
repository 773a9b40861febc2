"""The most device memory allocated during the untraced window
(max_memory_allocated after a reset at its start), in GiB."""

def read(run):
    return run.window.peak_bytes / 2 ** 30 if run.window.peak_bytes else None
