"""Milliseconds per circuit (a bank element counts as one) in which the
card idles inside the program's ``fusion.capture`` spans, over the traced
window: from the first gate buffered into an empty fusion buffer to the
drain's start, the API calls' validation and capture that the card waits
for.  Nothing where the program records no such span."""

from qtbench import spans as SP

LAYER = "API and capture"
UNIT = "ms"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    return SP.idle_ms_per_circuit(ctx, "fusion.capture")
