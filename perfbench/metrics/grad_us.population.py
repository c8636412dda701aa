"""Device us of the gradient step (`api.per_client_value_and_grad`)
in one eager round, split by the profiler."""

from pbench.readers import split_us


def read(ctx):
    return split_us(ctx, "gradient")
