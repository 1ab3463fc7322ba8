"""card_verifies_per_s: every verdict returned in the traced window over the
seconds in which the card ran a kernel, a copy or a memset in it
(torch.profiler's trace): the rate that the device layer sustains for this
traffic, whatever the host's pace.  It bounds ``verifies_per_s`` from above;
the two meet where the card is never idle."""


def read(ctx):
    if ctx.device is None or ctx.device.busy_s <= 0 or not ctx.verdicts:
        return None
    return ctx.verdicts / ctx.device.busy_s
