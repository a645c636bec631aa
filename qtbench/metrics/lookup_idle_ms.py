"""Milliseconds per circuit (a bank element counts as one) in which the
card idles inside the program's ``fusion.lookup`` spans (the plan key,
the memory and disk tiers of the plan cache, and planning on a miss),
over the traced window.  Nothing where the program records no such
span."""

from qtbench import spans as SP

LAYER = "optimizer, planner and dispatch"
UNIT = "ms"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    return SP.idle_ms_per_circuit(ctx, "fusion.lookup")
