"""dispatch_ms: the mean of the program's ``ed25519.device_dispatch`` spans in
the traced window, in ms: the upload and the kernel launches of a chunk."""

SPAN = "ed25519.device_dispatch"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
