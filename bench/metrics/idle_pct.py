"""The device's idle share of the traced sub-window: no kernel, copy or
fill running."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
