"""% of its byte bound reached by `fedgia_update_kernel` (donated, 0-d
h) in the traced window."""

from pbench.readers import update_roofline


def read(ctx):
    return update_roofline(ctx)
