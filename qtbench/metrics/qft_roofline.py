"""Share of their roofline that the QFT kernels (K6-K10) reach in the
traced window: the sum of each launch's least time, one read and one
write of every amplitude of the state over the card's memory rate (the
kernels are bound by bytes), over the sum of their device times."""

from qtbench import roofline as RF

LAYER = "QFT kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "circuits_per_s"
SOURCE = "device_trace"

KERNELS = ("qft_hi_kernel", "qft_sublane_kernel", "sigma_swap_kernel")


def read(ctx):
    events = [ev for ev in ctx.trace.device
              if ev.is_kernel and ev.function in KERNELS]
    if not events:
        return None
    least = RF.state_pass_bytes(ctx.num_amps) / RF.HBM_BYTES_PER_S
    return 100.0 * least * len(events) / sum(ev.seconds for ev in events)
