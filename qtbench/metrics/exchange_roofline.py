"""Share of the link's peak that the exchanges between the cards reach:
the bytes each card sends in the traced window's ``mesh.exchange`` spans
(their ``bytes`` attr: what each shard sends, one shard a card) over the
link's rate in one direction (``cards.LINK_BYTES_PER_S``), summed over the
cards, over the cards' device time inside those spans (the peer copies
and the splices of what they bring).  Under the profiler an exchange
waits for the mesh's cards before its span opens and before it closes,
so the work inside the span on a card is the exchange's own.  Nothing
where the program records no such span, or where cards hold more than one
shard (their exchanges then cross no link)."""

from qtbench import cards as CD
from qtbench import spans as SP

LAYER = "exchange"
UNIT = "%"
BETTER = "higher"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    records = SP.window_spans(ctx.trace, "mesh.exchange")
    seen = CD.cards(ctx.trace)
    if not records or len(seen) < ctx.shards:
        return None
    seconds = sum(CD.busy_inside(ctx.trace, c, records) for c in seen)
    if seconds <= 0.0:
        return None
    sent = len(seen) * sum(r["attrs"]["bytes"] for r in records)
    return 100.0 * sent / CD.LINK_BYTES_PER_S / seconds
