"""% of the card's peak the whole round reached: its least time (FP32
FLOPs at 67 TFLOP/s or bytes at 3.35 TB/s, the larger; bytes bind)
over the traced window's time a round."""

from pbench.readers import mfu
from pbench.yardstick import PEAK_FP32_FLOPS


def read(ctx):
    return mfu(ctx, PEAK_FP32_FLOPS)
