"""Host milliseconds a train_step call takes to return, without a
synchronize, over the window's steps: whether the host's issue sets the
pace."""


def read(ctx):
    return 1e3 * sum(ctx.issue_s) / len(ctx.issue_s) if ctx.issue_s else None
