"""What rate a plain stream of the state reaches on the card (P1).

The counterpart of ``scripts/probes/profile_dma.py``, whose Pallas kernel
(pallas_call at profile_dma.py:52) copied the canonical (2, 2^n/2^14,
128, 128) view of the state, or doubled it, through blocks of R x 128 x
128 amplitudes of both planes, in place or into a second buffer, beside
XLA's ``x * 0.5`` on the flat and the 4-d view.  Here the pass is the
hand-written ``stream_pass_kernel`` (``csrc/probes.cu``, through
``ops.stream.stream_pass``, one CTA per tile of R rows) and the library
yardstick is ``torch.Tensor.mul_(0.5)`` on the same two views.

At 26 qubits a pass moves 2 * 2 * 4 * 2^26 bytes (1.074 GB: 0.537 GB
read plus 0.537 GB written), at least 0.321 ms at 3.35 TB/s; the state
(512 MiB) is ten times the card's 50 MB L2, so chained passes stream
from device memory.

    python -m quest_tpu_torch.probes.profile_dma
"""

from __future__ import annotations

import torch

from ..ops import stream as S
from . import common

N = 26
ROWS = (4, 8, 16, 32, 64)     # R, the reference's block rows
CHAIN = 20                    # the reference's K: passes per timed chain
REPS = 5
SEED = 0


def stream(amps, *, rows: int, op: str, scale: float = 2.0, out=None):
    """The probe's pass: the P1 kernel on the card, its plain version on
    the CPU (``ops.stream.stream_pass`` itself refuses a CPU tensor)."""
    fn = S.stream_pass if amps.device.type == "cuda" else S.stream_pass_plain
    return fn(amps, rows=rows, op=op, scale=scale, out=out)


def cases(n: int) -> list:
    """(op, R, in place) of every case the parity check runs: both ops,
    every R of ``ROWS`` that tiles a plane of n qubits, in place and not."""
    hi = 1 << (n - 14)
    return [(op, r, inplace) for op in S.OPS for r in ROWS if hi % r == 0
            for inplace in (True, False)]


def check(device, n: int) -> dict:
    """Every case of ``cases(n)`` on a seeded state: the probe's pass
    ``torch.equal`` to the plain version on the same input (on the card
    the kernel, on the CPU the plain version itself)."""
    x0 = common.on(common.random_state(n, SEED), device)
    worst, done = 0.0, 0
    for op, rows, inplace in cases(n):
        x = x0.clone()
        out = None if inplace else torch.empty_like(x)
        y = stream(x, rows=rows, op=op, out=out)
        ref = S.stream_pass_plain(x0.clone(), rows=rows, op=op)
        worst = max(worst, float((y - ref).abs().max()))
        if not torch.equal(y, ref):
            raise RuntimeError(f"profile_dma: {op} R={rows} in place="
                               f"{inplace} at {n} qubits differs from the "
                               f"plain version by {worst}")
        done += 1
    return {"n": n, "cases": done, "max_abs_err": worst, "equal": True}


def run(device="cuda") -> dict:
    """The probe's timings at 26 qubits: ms a pass and GB/s over the
    pass's bytes, for ``mul_(0.5)`` on the flat and the 4-d view (the
    library yardstick), the stream copy at every R in place, the copy at
    R = 8 and 32 out of place, and the x2 at R = 8 and 32 in place; the
    launches of each case and the bound."""
    dev = common.cuda_device(device)
    num_amps = 1 << N
    nbytes = common.state_pass_bytes(num_amps)
    bound = nbytes / common.HBM_BYTES_PER_S * 1e3
    a = torch.zeros((2, num_amps), dtype=torch.float32, device=dev)
    a[0, 0] = 1.0
    spare = torch.empty_like(a)
    out = {"n": N, "bytes_per_pass": nbytes, "bound_ms": bound,
           "bound_by": "bytes", "chain": CHAIN, "cases": {}}

    def record(label, step, state, **extra):
        before = common.launches()
        med, low, _ = common.chain_ms(step, state, chain=CHAIN, reps=REPS)
        out["cases"][label] = {"ms": med, "min_ms": low,
                               "gbs": common.gbs(nbytes, med),
                               "fraction_of_bound": bound / med,
                               "launches": common.launched(before).get(
                                   "P1", 0), **extra}

    record("torch mul_(0.5) flat", lambda x: x.mul_(0.5), a,
           route="library")
    record("torch mul_(0.5) 4-d view", lambda x: x.mul_(0.5),
           a.view(2, num_amps >> 14, 128, 128), route="library")
    for r in ROWS:
        record(f"stream copy R={r} in place",
               lambda x, r=r: S.stream_pass(x, rows=r, op="copy"), a,
               rows=r, op="copy", in_place=True)
    # out of place: the chain ping-pongs between two buffers
    for r in (8, 32):
        bufs = [a, spare]

        def step(x, r=r, bufs=bufs):
            dst = bufs[1] if x is bufs[0] else bufs[0]
            return S.stream_pass(x, rows=r, op="copy", out=dst)

        record(f"stream copy R={r} out of place", step, a, rows=r,
               op="copy", in_place=False)
    for r in (8, 32):
        record(f"stream x2 R={r} in place",
               lambda x, r=r: S.stream_pass(x, rows=r, op="scale"), a,
               rows=r, op="scale", in_place=True)
    # the headline case, the x2 at R = 8 in place, beside its plain
    # version (one PyTorch call) and the library's mul_; the copy out of
    # place beside copy_
    x = common.device_state(N, SEED, dev)
    y = S.stream_pass(x.clone(), rows=8, op="scale")
    ref = S.stream_pass_plain(x.clone(), rows=8, op="scale")
    err = float((y - ref).abs().max())
    if not torch.equal(y, ref):
        raise RuntimeError(f"profile_dma: the x2 at R=8 differs from its "
                           f"plain version by {err}")
    del y, ref
    def once_ms(fn):
        return common.time_ms(fn, reps=3, warmup=1)

    head = dict(out["cases"]["stream x2 R=8 in place"])
    head.update(
        plain_ms=once_ms(lambda: S.stream_pass_plain(x, rows=8, op="scale")),
        library_ms=once_ms(lambda: x.mul_(2.0)),
        library_form="torch.Tensor.mul_(2.0)", max_abs_err=err,
        bound_ms=bound, bound_by="bytes")
    out["headline"] = head
    copy = out["cases"]["stream copy R=8 out of place"]
    copy["plain_ms"] = once_ms(lambda: S.stream_pass_plain(
        x, rows=8, op="copy", out=spare))
    copy["library_ms"] = once_ms(lambda: spare.copy_(x))
    copy["library_form"] = "torch.Tensor.copy_"
    out["ms_by_rows_copy_in_place"] = {
        r: out["cases"][f"stream copy R={r} in place"]["ms"] for r in ROWS}
    out["launches"] = {
        "P1": sum(c["launches"] for c in out["cases"].values())}
    del a, spare, x
    torch.cuda.empty_cache()
    return out


def main() -> int:
    return common.cli(run)


if __name__ == "__main__":
    raise SystemExit(main())
