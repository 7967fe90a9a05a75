"""Seconds from process start to the window's start: loading, seeding,
building and warming up."""


def read(ctx):
    return ctx.setup_s
