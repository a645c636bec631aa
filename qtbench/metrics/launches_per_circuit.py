"""Kernel launches on the card per circuit in the traced window, of every
name (copies and fills not counted): the planner's output as the card
sees it."""

LAYER = "planner output"
UNIT = "launches"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    kernels = sum(1 for ev in ctx.trace.device if ev.is_kernel)
    if not kernels or not ctx.circuits:
        return None
    return kernels / ctx.circuits
