"""stage_queue_ms: the mean of the program's ``ed25519.stage_queue`` spans
in the traced window, in ms: a chunk's wait from its submit to the stager
thread until that thread starts to stage it."""

SPAN = "ed25519.stage_queue"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
