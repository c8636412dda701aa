"""Device ms of eq. (11), `api.client_mean`, in one eager round."""

from pbench.readers import split_us


def read(ctx):
    us = split_us(ctx, "eq. (11)")
    return None if us is None else us / 1e3
