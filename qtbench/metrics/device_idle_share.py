"""Share of the traced window in which nothing ran on the card: one
minus the union (not the sum) of the device events' intervals over the
window's length."""

from qtbench import trace as TR

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace.window_s <= 0.0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - TR.busy_s(ctx.trace) / ctx.trace.window_s)
