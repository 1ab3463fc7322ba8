"""drain_copy_ms: the mean of the program's ``ed25519.drain_copy`` spans in
the traced window, in ms: the drain's work after its wait (the gate mask,
``tolist`` and the slice into the answer)."""

SPAN = "ed25519.drain_copy"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
