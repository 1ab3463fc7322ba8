"""device_idle_pct: the share of the window in which the card ran no kernel,
copy or memset (torch.profiler's trace), in %."""


def read(ctx):
    if ctx.device is None or ctx.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.device.busy_s / ctx.device.window_s)
