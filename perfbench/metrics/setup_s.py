"""Seconds from process start to the window: inputs, kernel loads (and
their build on a checkout's first run), the algorithm's state (the
Lipschitz probe), the first rounds, the window's warm-up and capture."""


def read(ctx):
    return ctx.setup_s
