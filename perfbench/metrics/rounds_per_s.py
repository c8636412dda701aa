"""Rounds a second: the window's rounds over its host-clock time,
host draws included (`RoundResult.rounds_run / wall_s`)."""


def read(ctx):
    return ctx.window["rounds"] / ctx.window["wall_s"]
