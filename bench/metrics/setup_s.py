"""Set-up: process start to the first timed step (loading, weights made on
the card, warm-up), on the host's clock."""


def read(ctx):
    return ctx["setup_s"]
