"""Measurement: probability -> threshold -> conditional collapse.

The port of the JAX package's ``ops/measurement.py``.  The reference's
measure is a host loop: a full-state probability reduction, a host
Mersenne-Twister draw, then a collapse sweep (statevec_measureWithStats,
QuEST_common.c:374-380; generateMeasurementOutcome, :168-183), so one
device-to-host round trip per qubit.  Here the outcome, its probability
and the collapse stay tensors on the register's device: the threshold of
each shot is JAX's threefry uniform for (key, shot), computed on the host
(``ops/threefry.py``, it depends on nothing else) and uploaded once per
call, and the outcome is selected on the device from the probability and
the threshold.  ``measure_sequence`` measures a list of qubits with one
upload and no host read between steps; the caller reads the outcomes
once, at the end.

The host-MT route (``QT_HOST_MEASURE=1``, or ``QT_STRICT_VALIDATION=1``)
stays for the reference's sampling stream: calcProbOfOutcome -> host
Mersenne Twister (rng.GLOBAL_RNG) -> collapse (``api_ops``).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from .. import validation as V
from ..precision import real_eps
from . import calculations as C
from . import threefry
from .kernels import _split2


def host_path_enabled() -> bool:
    """Route measure through the host Mersenne-Twister stream (the
    reference's exact sampling stream) instead of the device route."""
    return os.environ.get("QT_HOST_MEASURE") == "1" or V.strict_parity()


class _KeyState:
    """The measurement key and shot counter.  Seeded alongside the host
    MT by seedQuEST (env.seed_quest), as ``jax.random.PRNGKey(seeds[0])``
    folded with each further seed; each shot folds its index into the
    key, so the outcome stream is the JAX package's."""

    __slots__ = ("key", "counter")

    def __init__(self):
        self.key = None
        self.counter = 0

    def seed(self, seeds) -> None:
        self.key = threefry.key_from_seeds(seeds)
        self.counter = 0

    def next_shots(self, count: int = 1) -> Tuple[Tuple[int, int], int]:
        """(key, first shot index), reserving ``count`` consecutive shot
        indices."""
        if self.key is None:
            from ..rng import GLOBAL_RNG

            self.seed(GLOBAL_RNG._keys)
        shot = self.counter
        self.counter += count
        return self.key, shot

    def get_state(self) -> dict:
        """JSON-serialisable (key, shot counter) snapshot, the JAX
        package's ``KEYS.get_state()`` dict: ``{"key": [k0, k1],
        "counter": c}``."""
        key = None if self.key is None else [int(k) for k in self.key]
        return {"key": key, "counter": int(self.counter)}

    def set_state(self, state: dict) -> None:
        data = state.get("key")
        self.key = None if data is None else (int(data[0]) & 0xFFFFFFFF,
                                              int(data[1]) & 0xFFFFFFFF)
        self.counter = int(state.get("counter", 0))


KEYS = _KeyState()


def thresholds(key, shot: int, count: int, dtype, device) -> torch.Tensor:
    """The uniforms of shots shot .. shot + count - 1, as one (count,)
    tensor of the register's dtype on ``device`` (one upload)."""
    name = "float64" if dtype == torch.float64 else "float32"
    return torch.from_numpy(threefry.uniforms(key, shot, count, name)).to(
        device)


def _bit_factor(n: int, pos: int, outcome, dtype):
    """Indicator of (index bit ``pos`` == the 0-d tensor ``outcome``),
    broadcastable over the (2, 2^hi, 2^lo) view of the state."""
    hi, lo = _split2(n)
    if pos < lo:
        i = torch.arange(1 << lo, device=outcome.device)
        return (((i >> pos) & 1) == outcome).to(dtype)[None, None, :]
    i = torch.arange(1 << hi, device=outcome.device)
    return (((i >> (pos - lo)) & 1) == outcome).to(dtype)[None, :, None]


def _collapse_traced_sv(amps, n: int, target: int, outcome, prob):
    """Zero the discarded half, scale the kept half by 1/sqrt(prob), with
    the outcome and probability as device tensors
    (statevec_collapseToKnownProbOutcomeLocal, QuEST_cpu.c:3727-3815)."""
    hi, lo = _split2(n)
    v = amps.reshape(2, 1 << hi, 1 << lo)
    ind = _bit_factor(n, target, outcome, amps.dtype)
    return (v * (ind * torch.rsqrt(prob))).reshape(amps.shape)


def _collapse_traced_dm(amps, nq: int, target: int, outcome, prob):
    """Zero every rho element whose ket bit ``target`` or bra bit
    ``target + nq`` differs from the outcome, and renormalise by 1/prob
    (densmatr_collapseToKnownProbOutcome, QuEST_cpu.c:785-860)."""
    n = 2 * nq
    hi, lo = _split2(n)
    v = amps.reshape(2, 1 << hi, 1 << lo)
    ket = _bit_factor(n, target, outcome, amps.dtype)
    bra = _bit_factor(n, target + nq, outcome, amps.dtype)
    out = v * (ket * (1.0 / prob))
    out *= bra
    return out.reshape(amps.shape)


def _draw_outcome(p0, u):
    """generateMeasurementOutcome (QuEST_common.c:168-183) on the device:
    degenerate probabilities short-circuit; otherwise u <= p0 gives
    outcome 0.  Returns the outcome (int64) and its probability (the
    register's dtype), both 0-d tensors."""
    eps = real_eps()
    outcome = torch.where(
        p0 < eps, 1, torch.where(1 - p0 < eps, 0, torch.where(u <= p0, 0, 1)))
    prob = torch.where(outcome == 0, p0, 1 - p0)
    return outcome, prob


def _measure_once(amps, u, num_qubits: int, target: int, is_density: bool,
                  quad: bool = False):
    if is_density:
        p0 = C.calc_prob_of_outcome_density(
            amps, num_qubits=num_qubits, target=target, outcome=0,
            quad=quad)
    else:
        p0 = C.calc_prob_of_outcome_statevec(
            amps, num_qubits=num_qubits, target=target, outcome=0,
            quad=quad)
    if quad:
        # the double-double probability is combined on the host (one
        # read of 256 partials); the draw and collapse go on where the
        # state lies
        p0 = p0.to(dtype=amps.dtype, device=amps.device)
    outcome, prob = _draw_outcome(p0, u)
    if is_density:
        amps = _collapse_traced_dm(amps, num_qubits, target, outcome, prob)
    else:
        amps = _collapse_traced_sv(amps, num_qubits, target, outcome, prob)
    return amps, outcome, prob


def measure_fused(amps, key, shot: int, *, num_qubits: int, target: int,
                  is_density: bool, quad: bool = False):
    """One measurement shot on the device: probability reduction,
    threshold of shot ``shot``, conditional collapse.  Returns (new amps,
    outcome, outcome probability), the last two 0-d device tensors.
    ``num_qubits`` is the REPRESENTED count; ``quad`` (precision 4) takes
    the probability in double-double, as calcProbOfOutcome does."""
    u = thresholds(key, shot, 1, amps.dtype, amps.device)[0]
    return _measure_once(amps, u, num_qubits, target, is_density, quad)


def measure_sequence(amps, key, shot: int, *, num_qubits: int,
                     targets: Sequence[int], is_density: bool,
                     quad: bool = False):
    """Measure a sequence of qubits, each step collapsing before the next
    qubit's probability is taken, exactly as a loop of measure_fused
    calls with shots shot .. shot + len(targets) - 1 would: the same
    outcomes and probabilities, bit for bit.  One threshold upload, and
    no read on the host (except under ``quad``, whose compensated combine
    reads 256 partials per qubit): returns (new amps, outcomes (k,)
    int64, probabilities (k,)) as device tensors."""
    us = thresholds(key, shot, len(targets), amps.dtype, amps.device)
    outs, probs = [], []
    for j, t in enumerate(targets):
        amps, o, p = _measure_once(amps, us[j], num_qubits, t, is_density,
                                   quad)
        outs.append(o)
        probs.append(p)
    return amps, torch.stack(outs), torch.stack(probs)


def to_host(outcomes, probs):
    """Outcomes and probabilities as Python ints and floats, in ONE
    device-to-host copy (outcomes 0/1 travel exactly in the
    probabilities' dtype)."""
    pair = torch.stack((outcomes.to(probs.dtype), probs)).cpu()
    return [int(o) for o in pair[0].tolist()], pair[1].tolist()
