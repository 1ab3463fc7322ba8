"""verifies_per_s: every verdict returned in the window over the window's
seconds, by the host's clock."""


def read(ctx):
    return ctx.verdicts / ctx.window_s if ctx.window_s > 0 and ctx.verdicts else None
