"""Peak device memory allocated in the window (``max_memory_allocated``
after ``reset_peak_memory_stats`` at its start), GiB."""


def read(ctx):
    if ctx["memory_peak_bytes"] == 0:
        return None
    return ctx["memory_peak_bytes"] / 2**30
