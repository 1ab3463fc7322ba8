"""host_stage_ms: the mean of the program's ``ed25519.host_hash`` spans in the
traced window, in ms: the host stage of a chunk (the strict gate, SHA-512
mod L where the host hashes, the packed layout)."""

SPAN = "ed25519.host_hash"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
