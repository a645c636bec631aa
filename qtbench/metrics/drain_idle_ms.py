"""Milliseconds per circuit in which the card idles while the host is
inside the program's ``fusion.drain`` span (the optimizer, the plan
lookup or planning, and the dispatch of the program's launches), over the
traced window: the drain's host work that the card waits for.  Time in
the span during which the card runs (the launches the drain dispatches,
the copies and waits it makes) is left out, so a faster kernel does not
lower it.  Nothing where the circuit does not drain."""

from qtbench import trace as TR

LAYER = "optimizer, planner and dispatch"
UNIT = "ms"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    if not ctx.circuits or not any(name == "fusion.drain"
                                   for name, _s, _e in ctx.trace.host):
        return None
    return TR.idle_within(ctx.trace, "fusion.drain") / ctx.circuits * 1e3
