"""Share of the cards' busy time in the traced window that the drain's
window remaps take: on each card the device time inside the program's
``mesh.remap`` spans (the peer copies of its half-shard swaps, their
splices into the shard and any local axis permute), summed over the
cards, over the cards' summed busy time.  Under the profiler a remap
waits for the mesh's cards before its span opens and before it closes
(``dist.settle_traced``), so the work inside the span on a card is the
remap's own.  Nothing where the program records no such span."""

from qtbench import cards as CD
from qtbench import spans as SP
from qtbench import trace as TR

LAYER = "exchange"
UNIT = "%"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    records = SP.window_spans(ctx.trace, "mesh.remap")
    busy = sum(TR.busy_s(ctx.trace, c) for c in CD.cards(ctx.trace))
    if not records or busy <= 0.0:
        return None
    inside = sum(CD.busy_inside(ctx.trace, c, records)
                 for c in CD.cards(ctx.trace))
    return 100.0 * inside / busy
