"""ed25519_verify_roofline: the least time the card needs for the verifies
of the traced window's gate-passing lanes (``port_bench/roofline.py``), over
the device time of the kernels named ``ed25519_verify*`` in the trace, in %."""

from port_bench import devtrace, roofline


def read(ctx):
    if ctx.device is None:
        return None
    return roofline.share_pct(
        ctx.lanes["gate_ok"], roofline.B1_OPS_PER_LANE, roofline.B1_BYTES_PER_LANE,
        devtrace.kernel_seconds(ctx.device, roofline.B1_KERNEL),
    )
