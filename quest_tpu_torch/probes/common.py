"""What the probes and ``chip_smoke.py`` share: the card's peaks, the
least times the card could take, the tolerances a kernel is held to
against its plain version, CUDA-event timing, the library yardsticks of
the window passes and the seeded inputs.

Every time here is device time on a CUDA card.  ``cuda_device`` refuses
any other device before anything runs, so no probe reports a time taken
on the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import cplx, fused, paulis, stream

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bandwidth and the highest rate of each type for elementwise work: FP32
# on the CUDA cores, FP64 on the tensor cores (DMMA; twice the CUDA cores'
# 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# The window kernels' matrix products (K1, K2, K11, K12): a float32
# product accurate to float32 costs at least three TF32 tensor-core
# products (the TF32 split of csrc/window.cu), so the least time is the
# flops over a third of the dense TF32 rate, 495 TFLOP/s; float64 runs on
# DMMA at the FP64 tensor-core rate.
WINDOW_FLOPS = {"float32": 495e12 / 3, "float64": 67e12}
# The least time of a float32 pass's products under each matmul mode:
# "highest" as above, "bf16_3x" three bf16 products at the dense bf16
# rate, "default" one TF32 product at the TF32 rate.
MODE_FLOPS = {"highest": WINDOW_FLOPS["float32"], "bf16_3x": 989e12 / 3,
              "default": 495e12}
# Each lower mode's per-product error (relative): "bf16_3x" drops x_l m_l
# and rounds the low parts, about 2^-16; "default" rounds both operands to
# TF32, about 2^-11.
MODE_UNIT = {"bf16_3x": 2.0 ** -16, "default": 2.0 ** -11}
TIME_REPS = 10            # timed calls of ``time_ms`` by default


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_device(device) -> torch.device:
    """``device`` as a torch.device if it is a CUDA card that is present;
    a RuntimeError otherwise (the probes time nothing on the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes' timings run only on a CUDA card, "
                           f"not on {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("the probes' timings need a CUDA card, and none "
                           "is available")
    return dev


def cli(run) -> int:
    """A probe's ``main()``: on the card only, the card's name and power
    limit, then one JSON line per timed case of ``run()`` and one with
    the rest of its result."""
    cuda_device("cuda")
    emit({"nvidia_smi": nvidia_smi_line(),
          "device": torch.cuda.get_device_name(0)})
    res = run()
    for label, case in res.pop("cases", {}).items():
        emit({"case": label, **case})
    emit(res)
    return 0


def launches() -> dict:
    """Every kernel wrapper's launch count a probe can reach."""
    return {**fused.LAUNCHES, **paulis.LAUNCHES, **stream.LAUNCHES}


def launched(before: dict) -> dict:
    """The launches since ``before`` (a ``launches()``), by kernel."""
    return {k: v - before.get(k, 0) for k, v in launches().items()
            if v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = TIME_REPS, warmup: int = 2) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chain_ms(step, state, *, chain: int, reps: int = 5):
    """(median, least) device ms per launch of ``state = step(state)``,
    chained ``chain`` times between two CUDA events, over ``reps`` chains
    after one warm-up launch (which also makes the side images); and the
    last state."""
    state = step(state)
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            state = step(state)
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / chain)
    return statistics.median(per), min(per), state


# ---------------------------------------------------------------------------
# the least time the card could take
# ---------------------------------------------------------------------------


def state_pass_bytes(num_amps: int, itemsize: int = 4) -> int:
    """Bytes of one pass over the state: each amplitude of both planes
    read once and written once."""
    return 2 * 2 * itemsize * num_amps


def gbs(nbytes: int, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def least_ms(nbytes: float, flops: float, rate: float):
    """(least ms, "bytes" or "operations"): the larger of ``nbytes`` over
    the memory rate and ``flops`` over ``rate``, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def pass_flops(num_amps: int, rank: int, sides: int, mask: bool) -> float:
    """Real flops of one window pass: 8 per complex multiply-add, 128 per
    output amplitude per side per rank, plus 6 per amplitude for a mask."""
    return (8.0 * 128 * rank * sides * num_amps
            + (6.0 * num_amps if mask else 0.0))


def flops_of(op, num_amps: int) -> float:
    """``pass_flops`` of the pass ("winfused", k, A, B, apply_a, apply_b
    [, mask])."""
    return pass_flops(num_amps, int(op[2].shape[0]),
                      int(bool(op[4])) + int(bool(op[5])),
                      len(op) > 6 and op[6] is not None)


def bound_ms(ops, state_bytes: int, num_amps: int, dtype_name: str,
             rate=None):
    """The least time the card could take for a run of window passes: one
    read and one write of the state plus each matrix read once, over the
    memory rate, against the flops over the window products' rate
    (``rate``, by default WINDOW_FLOPS); and which of the two bounds
    it."""
    mat_bytes = sum(op[2].numel() * op[2].element_size()
                    * (int(bool(op[4])) + int(bool(op[5])))
                    + (0 if op[6] is None
                       else op[6].numel() * op[6].element_size())
                    for op in ops)
    return least_ms(2 * state_bytes + mat_bytes,
                    sum(flops_of(op, num_amps) for op in ops),
                    rate or WINDOW_FLOPS[dtype_name])


def window_bound(num_amps: int, rank: int, sides: int, mask: bool,
                 precision: str = "highest"):
    """``bound_ms`` of one float32 pass on a state of ``num_amps``
    amplitudes with ``rank`` float32 (2, 128, 128) matrices on each of
    ``sides`` sides [and a mask], at ``precision``'s product rate."""
    mats = 4 * 2 * 128 * 128 * (rank * sides + (1 if mask else 0))
    return least_ms(state_pass_bytes(num_amps) + mats,
                    pass_flops(num_amps, rank, sides, mask),
                    MODE_FLOPS[precision])


# ---------------------------------------------------------------------------
# how far a kernel may stray from its plain version
# ---------------------------------------------------------------------------


def tolerance(x) -> float:
    """How far a kernel may stray from its plain version on state ``x``
    (normalised).  float32: sums of 128-term products of unit-scale
    factors, each rounded at 2^-24 relative, taken in another order than
    the plain version's library einsum -> 1e-5 of the state's largest
    amplitude.  float64: the same at 2^-53 -> 1e-12 absolute."""
    if x.dtype == torch.float32:
        return 1e-5 * float(x.abs().max())
    return 1e-12


def mode_tolerance(x, mode: str, model: bool) -> float:
    """How far a float32 pass under ``mode`` may stray, per pass, on the
    normalised state ``x``.  Against the mode's model (``model``,
    fused.window_pass_split): the products are the same exact products,
    summed in another order, but a dual pass splits its float32
    intermediate T again, and where T's kernel and model values straddle
    a rounding step of the split one low part moves by one unit, a
    product by the mode's unit: MODE_UNIT max|x|.  Against the full
    float32 plain version: four per-product errors, 4 MODE_UNIT max|x|
    (measured on the CPU at 20 qubits: 6.5e-6 and 3.9e-4 max|x| for
    rank-1 dual passes)."""
    return (1 if model else 4) * MODE_UNIT[mode] * float(x.abs().max())


def model_tolerance(x, precision: str) -> float:
    """How far a float32 window pass on ``x`` may stray from the plain
    version of its mode (``fused.window_pass_model``)."""
    if precision == "highest":
        return tolerance(x)
    return mode_tolerance(x, precision, True)


# ---------------------------------------------------------------------------
# the library yardsticks: one torch.einsum for the function of a pass
# ---------------------------------------------------------------------------


def _complex(m, lead: int = 0):
    """The complex tensor of SoA ``m`` whose planes are axis ``lead``."""
    return torch.complex(*m.unbind(lead))


def window_library(x, mats_a, mats_b, mask, *, num_qubits: int, k: int,
                   apply_a: bool):
    """Single ``torch.einsum`` calls on complex views computing the same
    function as a window pass Y = [mask (.)] sum_r B_r X A_r^T (B-only
    without A), as {subscripts: call}, in both operand orders (B.X first,
    X.A first) where the pass has both sides: yardsticks only, the port
    never calls them.  At rank 1 the forms carry no rank axis."""
    hi = 1 << (num_qubits - k - 7)
    mid = 1 << (k - 7)
    xc = cplx.to_complex(x.reshape(2, hi, 128, mid, 128))
    ac, bc = _complex(mats_a, 1), _complex(mats_b, 1)
    r = ""
    if mats_a.shape[0] == 1:
        ac, bc = ac[0], bc[0]
    else:
        r = "r"
    if apply_a:
        forms = {f"{r}qw,hwml,{r}pl": (bc, xc, ac),
                 f"hwml,{r}pl,{r}qw": (xc, ac, bc)}
        out, m_s = "hqmp", "qp"
    else:
        forms = {f"{r}qw,hwml": (bc, xc)}
        out, m_s = "hqml", "ql"
    calls = {}
    for sub, args in forms.items():
        if mask is not None:
            sub = f"{sub},{m_s}"
            args = (*args, cplx.to_complex(mask))
        sub = f"{sub}->{out}"
        calls[sub] = lambda sub=sub, args=args: torch.einsum(sub, *args)
    return calls


def cluster_library(x, a, b, swap=None, *, bank: bool = False):
    """Single torch.einsum calls computing the same function as K11
    (``swap`` is None) or K12 (``swap`` = (h, b, m)) on the canonical state
    ``x``, as {subscripts: call}: yardsticks only, the port never calls
    them.  The operand order sets the contraction path (B.X first or X.A
    first), and a size-1 axis before the lanes (K1's view at k = 7)
    changes how torch lays the products out; the fastest form is the
    library time.  At rank 1 the forms carry no rank axis.  For K12 the
    state is viewed with the two swapped m-bit fields as their own axes,
    so the swap is a relabelling of axes inside the one call.  With
    ``bank`` the state is a (B, 2, 2^n) bank and the sides are each
    element's rank-1 (B, 1, 2, 128, 128): the element is an axis z of
    every operand."""
    lead = x.shape[:1] if bank else ()
    z = "z" if bank else ""
    if bank:
        a, b = a[:, 0], b[:, 0]
    ac, bc = _complex(a, 1), _complex(b, 1)
    slabs = x.numel() // (2 * 128 * 128 * (lead[0] if bank else 1))
    if swap is None:
        xc = _complex(x.reshape(*lead, 2, slabs, 128, 128), len(lead))
        bv, xs, out = "qw", "gwl", "gqp"
    else:
        h, bq, m = swap
        mm = 1 << m
        glo = 1 << (h - 14)
        rlo = 1 << (bq - 7)
        ghi, rhi = slabs // (glo * mm), 128 // (mm * rlo)
        # slab = (ghi, slab field, glo), row = (rhi, row field, rlo)
        xc = _complex(x.reshape(*lead, 2, ghi, mm, glo, rhi, mm, rlo, 128),
                      len(lead))
        bc = bc.reshape(*bc.shape[:-2], 128, rhi, mm, rlo)
        bv, xs, out = "qrto", "atcrsol", "ascqp"
    av = "pl"
    if bank:
        av, bv = "z" + av, "z" + bv
    elif a.shape[0] > 1:
        av, bv = "k" + av, "k" + bv
    else:
        ac, bc = ac[0], bc[0]
    forms = {}
    for xv, xo, xt in ((z + xs, z + out, xc),
                       (z + xs[:-1] + "m" + xs[-1],
                        z + out[:-1] + "m" + out[-1], xc.unsqueeze(-2))):
        bx = f"{bv},{xv},{av}->{xo}"
        xa = f"{xv},{av},{bv}->{xo}"
        forms[bx] = lambda bx=bx, xt=xt: torch.einsum(bx, bc, xt, ac)
        forms[xa] = lambda xa=xa, xt=xt: torch.einsum(xa, xt, ac, bc)
    return forms


def library_time(y, forms: dict, tol: float, what: str, *,
                 plane_axis: int = 0, reps: int = 5):
    """Checks every einsum form against the kernel's output ``y`` (its
    real and imaginary planes on ``plane_axis``) within ``tol`` and times
    each: (fastest ms, its subscripts, {subscripts: ms})."""
    times = {}
    for form, fn in forms.items():
        got = torch.view_as_real(fn()).movedim(-1, plane_axis)
        diff = float((y - got.reshape(y.shape)).abs().max())
        del got
        if diff > tol:
            raise RuntimeError(f"{what}: the einsum yardstick {form} "
                               f"computes another function (|diff| {diff})")
        times[form] = time_ms(fn, reps=reps)
    best = min(times, key=times.get)
    return times[best], best, times


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------


def random_unitary(rng, dim: int) -> np.ndarray:
    """A Haar-random unitary from ``rng``."""
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def side_stack(rng, rank: int) -> np.ndarray:
    """(rank, 2, 128, 128) float32 SoA unitaries scaled by 1/rank, so a
    pass keeps the state's scale."""
    return np.stack([np.stack([u.real, u.imag]) / rank
                     for u in (random_unitary(rng, 128)
                               for _ in range(rank))]).astype(np.float32)


def random_state(n: int, seed: int) -> np.ndarray:
    """A normalised (2, 2^n) float32 state from ``seed``."""
    x = np.random.default_rng(seed).standard_normal((2, 1 << n))
    x /= np.sqrt(np.sum(x * x))
    return x.astype(np.float32)


def device_state(n: int, seed: int, device) -> torch.Tensor:
    """A normalised (2, 2^n) float32 state drawn on ``device`` from
    ``seed`` (the timings' inputs, made without a host round trip)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2, 1 << n), generator=gen, device=device)
    return x.div_(torch.sqrt(torch.sum(x * x)))


def on(arr, device) -> torch.Tensor:
    """A NumPy array as a contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)
