"""stage_gil_wait_ms: the mean of the program's ``ed25519.stage_gil_wait``
spans in the traced window, in ms: the C host stage's wait to take the GIL
back after its compute, while another thread holds it."""

SPAN = "ed25519.stage_gil_wait"


def read(ctx):
    d = [b - a for n, a, b in ctx.spans if n == SPAN]
    return 1e3 * sum(d) / len(d) if d else None
