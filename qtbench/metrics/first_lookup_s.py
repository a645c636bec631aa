"""Seconds of the first drain's ``fusion.lookup`` span in the process, in
set-up: the plan key and the plan loaded from the persistent plan cache,
or planned.  Nothing where the program records no such span, or where
its span ring has dropped its oldest records."""

from qtbench import spans as SP

LAYER = "set-up"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    records = [r for r in SP.program_spans() if r["name"] == "fusion.lookup"]
    if not records or SP.ring_dropped():
        return None
    first = min(records, key=lambda r: r["start_ns"])
    return (first["end_ns"] - first["start_ns"]) * 1e-9
