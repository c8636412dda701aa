"""Host ms a round drawing FedGiA's split or the policy's mask a chunk
ahead (`RoundResult.draw_s`), in the traced window."""


def read(ctx):
    return ctx.window["draw_s"] * 1e3 / ctx.window["rounds"]
