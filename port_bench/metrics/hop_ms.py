"""hop_ms: the program's thread hops a call, in ms: its ``sig.hop_out``
(the worker thread's start) and ``sig.hop_back`` (from the worker's end to
the caller's return from its wait) spans summed over the traced window,
over the window's calls."""

HOPS = ("sig.hop_out", "sig.hop_back")
CALL = "port_bench.call"


def read(ctx):
    hops = [b - a for n, a, b in ctx.spans if n in HOPS]
    calls = sum(1 for n, _, _ in ctx.spans if n == CALL)
    return 1e3 * sum(hops) / calls if hops and calls else None
