"""Device kernels a prefill batch in the traced sub-window."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["units"]
