"""batch_ms.p95: the 95th percentile of the wall time of every call the
window made, in ms (linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.call_ms, 95)) if len(ctx.call_ms) else None
