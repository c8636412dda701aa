"""% of the card's bf16 peak (989 TFLOP/s) in model FLOPs: the round's
tokens x `ref_qwen2.flops_per_token` over the traced window's time a
round."""

from pbench.readers import mfu
from pbench.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    return mfu(ctx, PEAK_BF16_FLOPS)
