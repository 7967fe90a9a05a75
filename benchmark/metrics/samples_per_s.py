"""Training samples stepped in the window, over the window, which ends
after the card has finished every step."""


def read(ctx):
    return ctx.samples / ctx.window_s
