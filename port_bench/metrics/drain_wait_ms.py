"""drain_wait_ms: the mean of the program's ``ed25519.drain_wait`` spans in
the traced window, in ms: the drain's wait for a chunk's event (the card's
verdicts back in host memory)."""

SPAN = "ed25519.drain_wait"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
