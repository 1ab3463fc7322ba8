"""launch_latency_us: how long the card takes to start a chunk that the
host launches onto an idle card, in us: over the program's
``ed25519.launch`` spans that opened in an idle gap of the device trace,
the median of the start of the chunk's upload (its ``Memcpy HtoD``, the
chunk's first device operation) minus the span's start.  The k-th launch is
paired with the k-th upload of the window (one upload a chunk; nothing to
read where the counts differ).  The spans and the device trace share the
host's monotonic clock, so the reading is never below 0 unless they do
not."""

import bisect
import statistics

SPAN = "ed25519.launch"
UPLOAD = "Memcpy HtoD"


def read(ctx):
    if ctx.device is None:
        return None
    launches = sorted(a for n, a, _ in ctx.spans if n == SPAN)
    uploads = sorted(a for n, a, _ in ctx.device.ops if n.startswith(UPLOAD))
    if not launches or len(launches) != len(uploads):
        return None
    gaps = ctx.device.gaps  # in time order
    starts = [g0 for g0, _ in gaps]
    lat = []
    for a, up in zip(launches, uploads):
        j = bisect.bisect_right(starts, a) - 1
        if j >= 0 and a < gaps[j][1]:  # the card ran nothing at the launch
            lat.append(up - a)
    return 1e6 * statistics.median(lat) if lat else None
