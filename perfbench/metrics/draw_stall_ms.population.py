"""Device ms a round of the traced window's chunk-boundary gaps that fall
inside the host's `driver.draw` spans: the device waiting on the draws
of FedGiA's split or the policy's masks."""

from pbench import span_readers


def read(ctx):
    return span_readers.draw_stall_ms(span_readers.recording(),
                                      ctx.window["rounds"])
