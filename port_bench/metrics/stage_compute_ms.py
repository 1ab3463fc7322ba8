"""stage_compute_ms: the mean of the program's ``ed25519.stage_compute``
spans in the traced window, in ms: the C host stage's compute with the GIL
released (the gate, the hash of multi-block messages, the packed layout)."""

SPAN = "ed25519.stage_compute"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
