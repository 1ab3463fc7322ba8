"""gc_pct: the share of the traced window that the interpreter spent in
collections of generation 1 and 2, the program's ``py.gc`` spans (every
Python thread stops for them), clipped to the window's calls, in %."""

SPAN = "py.gc"
CALL = "port_bench.call"


def read(ctx):
    calls = [(a, b) for n, a, b in ctx.spans if n == CALL]
    gcs = [(a, b) for n, a, b in ctx.spans if n == SPAN]
    if not calls or not gcs or ctx.window_s <= 0:
        return None
    lo, hi = min(a for a, _ in calls), max(b for _, b in calls)
    s = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in gcs)
    return 100.0 * s / ctx.window_s
