"""GiB: `torch.cuda.max_memory_allocated()` over set-up and window,
reset at process start."""

from pbench.readers import GIB


def read(ctx):
    return ctx.peak_bytes / GIB if ctx.peak_bytes else None
