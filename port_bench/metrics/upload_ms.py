"""upload_ms: the device time of the window's host-to-device copies a chunk,
in ms (torch.profiler's trace; chunks by the program's counter)."""


def read(ctx):
    chunks = ctx.counters.get("device_calls", 0)
    if ctx.device is None or not chunks:
        return None
    s = sum(b - a for n, a, b in ctx.device.ops if n.startswith("Memcpy HtoD"))
    return 1e3 * s / chunks if s > 0 else None
