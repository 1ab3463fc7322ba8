"""step_mfu: the work that the window's verdicts need (B1 for every
gate-passing lane and B2 for every gate-passing one-block lane, wherever the
program does it; ``port_bench/roofline.py``) over the card's INT32 peak for
the whole window by the host's clock, in %.  It bounds ``verifies_per_s``
as the kernels' roofline shares cannot: a kernel taken off the path leaves
its share silent, and this one still counts the work."""

from port_bench import roofline


def read(ctx):
    if ctx.window_s <= 0 or not ctx.lanes["gate_ok"]:
        return None
    ops = (ctx.lanes["gate_ok"] * roofline.B1_OPS_PER_LANE
           + ctx.lanes["one_block"] * roofline.B2_OPS_PER_LANE)
    return 100.0 * ops / (roofline.INT32_PER_S * ctx.window_s)
