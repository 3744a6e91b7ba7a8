"""Prefill throughput: prompt tokens of every batch completed in the
window over the window's length."""


def read(ctx):
    if ctx["kind"] != "prefill":
        return None
    return ctx["window"]["tokens"] / ctx["window"]["seconds"]
