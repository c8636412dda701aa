"""Device us of the diag_ema H refresh (`hparams.update_diag_h`) in
one eager round, split by the profiler."""

from pbench.readers import split_us


def read(ctx):
    return split_us(ctx, "H refresh")
