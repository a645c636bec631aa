"""Share of their roofline that the window kernels (K1, K2, K11, K12)
reach on the shards of a split register: the sum of each launch's least
time over the sum of their device times, on every card, in the traced
window.  Each planned pass of the drain's program launches once on each
shard, over a shard's amplitudes (``ctx.num_amps``); its least time is
the larger of its bytes over the card's memory rate and its operations
over the dense TF32 rate (``roofline.py``).  Where the launches do not
match the plan (drains x passes x shards), bytes alone bound them.
Nothing on a register held whole (``window_roofline`` reads that)."""

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
    if ctx.shards < 2 or not events:
        return None
    bytes_only = RF.state_pass_bytes(ctx.num_amps) / RF.HBM_BYTES_PER_S
    costs = ctx.window_costs
    if costs and len(events) == ctx.drains * len(costs) * ctx.shards:
        least = [RF.least_s(*c) if c is not None else bytes_only
                 for c in costs] * (ctx.drains * ctx.shards)
    else:
        ctx.log(f"shard_window_roofline: {len(events)} launches against "
                f"{ctx.drains} drains of {len(costs)} passes on "
                f"{ctx.shards} shards: bytes alone")
        least = [bytes_only] * len(events)
    return 100.0 * sum(least) / sum(ev.seconds for ev in events)
