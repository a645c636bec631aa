"""Host milliseconds per circuit spent in the circuit's API calls (gate
validation and capture into the fusion buffer), over the traced window:
the harness's clock around each circuit's loop of calls, summed, over the
circuits (a bank element counts as one)."""

LAYER = "API and capture"
UNIT = "ms"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "host_clock"


def read(ctx):
    if not ctx.circuits:
        return None
    return ctx.gate_calls_s / ctx.circuits * 1e3
