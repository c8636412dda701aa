"""Training tokens a second: every client takes one gradient at x̄ a
round over its sequences, so a round trains clients x sequences x
tokens; over the window's host-clock time."""


def read(ctx):
    return ctx.window["rounds"] * ctx.sut.round_tokens / ctx.window["wall_s"]
