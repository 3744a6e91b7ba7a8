"""Training throughput: tokens of every step completed in the window over
the window's length."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["window"]["tokens"] / ctx["window"]["seconds"]
