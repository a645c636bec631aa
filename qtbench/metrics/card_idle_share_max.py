"""The largest of the cards' idle shares over the traced window: for
each card the window less the union of its device events' intervals,
over the window.  On a register split over several cards it shows a card
that waits: on a host that feeds the shards one after another, or on a
partner in an exchange."""

from qtbench import cards as CD
from qtbench import trace as TR

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    seen = CD.cards(ctx.trace)
    if ctx.trace.window_s <= 0.0 or not seen:
        return None
    return 100.0 * max(1.0 - TR.busy_s(ctx.trace, c) / ctx.trace.window_s
                       for c in seen)
