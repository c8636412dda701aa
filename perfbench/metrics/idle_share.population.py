"""% of the traced replayed window with no device operation running."""

from pbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
