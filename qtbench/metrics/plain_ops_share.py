"""Share of the card's time in the traced window spent outside the port's
own CUDA kernels (every ``__global__`` function of its ``csrc/``): the
executor's plain PyTorch ops (permutation gathers, copies, fills) and the
read-outs' reductions, over all device time."""

LAYER = "executor plain ops"
UNIT = "%"
BETTER = "lower"
MOVES = "circuits_per_s"
SOURCE = "device_trace"


def read(ctx):
    total = sum(ev.seconds for ev in ctx.trace.device)
    if total <= 0.0:
        return None
    plain = sum(ev.seconds for ev in ctx.trace.device
                if not (ev.is_kernel and ev.function in ctx.port_kernels))
    return 100.0 * plain / total
