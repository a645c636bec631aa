"""Seconds of the run's first circuit, in set-up and untimed: planning or
loading the plan from the persistent plan cache, the first allocations
and the first launches."""

LAYER = "set-up"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.first_circuit_s
