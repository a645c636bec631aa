"""Permutation gathers (``gatherperm`` ops) per circuit the harness runs
(a bank of elements is one: its batched gathers take the whole bank),
over the traced window: the sum of the ``gatherperm`` attr of the
program's ``fusion.dispatch`` spans (each group's op counts, from
``circuit.stats`` of its planned parts) over the drains.  Nothing where
the program records no such span."""

from qtbench import spans as SP

LAYER = "executor plain ops"
UNIT = "ops"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    records = SP.window_spans(ctx.trace, "fusion.dispatch")
    if not records or not ctx.drains:
        return None
    return sum(r["attrs"].get("gatherperm", 0) for r in records) / ctx.drains
