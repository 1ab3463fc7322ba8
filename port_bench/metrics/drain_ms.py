"""drain_ms: the mean of the program's ``ed25519.drain`` spans in the traced
window, in ms: the drain of a chunk (its wait for the card's verdicts, the
mask and the copy into the answer)."""

SPAN = "ed25519.drain"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
