"""Device ms a round with no chunk running in the traced window's driver
call: from each chunk's last mark to the next chunk's first (the port's
`driver.*` marks); the first chunk's draw, before its first mark, is not
a boundary."""

from pbench import span_readers


def read(ctx):
    return span_readers.boundary_idle_ms(span_readers.recording(),
                                         ctx.window["rounds"])
