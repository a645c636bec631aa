"""Share of their roofline that the window kernels (K1, K2, K11, K12 and
their bank forms) reach: the sum of each launch's least time over the sum
of their device times, in the traced window.

A launch's least time is the larger of its bytes (one read and one write
of the amplitudes it covers) over the card's memory rate and its
operations (the pass's complex products, from its shape in the plan the
drain ran) over the dense TF32 rate.  Where the plan is not read (a
circuit that does not drain, such as ``applyFullQFT``'s reversal
passes) or a launch's shape is not, its bytes alone bound it."""

from qtbench import roofline as RF

LAYER = "window kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "circuits_per_s"
SOURCE = "device_trace"

KERNELS = ("window_pass_kernel", "megawin_kernel", "swap_cluster_kernel")


def read(ctx):
    events = [ev for ev in ctx.trace.device
              if ev.is_kernel and ev.function in KERNELS]
    if not events:
        return None
    bytes_only = RF.state_pass_bytes(ctx.num_amps) / RF.HBM_BYTES_PER_S
    costs = ctx.window_costs
    if costs and len(events) == ctx.drains * len(costs):
        least = [RF.least_s(*c) if c is not None else bytes_only
                 for c in costs] * ctx.drains
    else:
        if costs:
            ctx.log(f"window_roofline: {len(events)} launches against "
                    f"{ctx.drains} drains of {len(costs)}: bytes alone")
        least = [bytes_only] * len(events)
    return 100.0 * sum(least) / sum(ev.seconds for ev in events)
