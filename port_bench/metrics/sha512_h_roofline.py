"""sha512_h_roofline: the least time the card needs to hash the traced
window's gate-passing one-block lanes (``port_bench/roofline.py``), over the
device time of the kernels named ``sha512_h*`` in the trace, in %.  Nothing
to read where no such kernel ran (the host hashes)."""

from port_bench import devtrace, roofline


def read(ctx):
    if ctx.device is None:
        return None
    return roofline.share_pct(
        ctx.lanes["one_block"], roofline.B2_OPS_PER_LANE, roofline.B2_BYTES_PER_LANE,
        devtrace.kernel_seconds(ctx.device, roofline.B2_KERNEL),
    )
