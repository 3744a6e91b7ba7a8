"""The whole step's (or batch's) share of the card's bf16 peak: the
benchmark's analytic model operations (``bench/counts.py``) of every unit
completed in the window, over the window's length, over the peak."""


def read(ctx):
    if ctx["memory_peak_bytes"] == 0:      # no card: no device number
        return None
    win = ctx["window"]
    return 100 * win["flops"] / win["seconds"] / ctx["peak_flops"]
