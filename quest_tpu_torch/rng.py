"""The host measurement RNG: the QT_HOST_MEASURE=1 outcome stream.

A copy of the JAX package's ``rng.py``.  The reference draws each
measurement outcome from a Mersenne Twister (mt19937ar.c) seeded from
time+pid (QuEST_common.c:195-227); here the same generator family,
numpy's MT19937, seeded through numpy's SeedSequence exactly as the JAX
package seeds it, so the same seeds give the same stream in both
packages.  The default (fused) measurement route draws from the
threefry key stream instead (``ops/measurement.py``).

Reproducibility: the time+pid DEFAULT seed is always recorded -- one
``quest_tpu_torch.rng.default_seed`` JSON line on stderr, the keys shown
as ``DefaultSeed=`` in ``getEnvironmentString`` (env.py), and
:attr:`_MeasurementRNG.default_seeded` marking a stream never seeded
explicitly -- so any run replays with ``seedQuEST(env, <logged keys>)``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Sequence

import numpy as np


class _MeasurementRNG:
    def __init__(self):
        self.seed_default()

    def seed(self, seeds: Sequence[int]) -> None:
        self._keys = [int(s) & 0xFFFFFFFF for s in seeds]
        self._rng = np.random.RandomState(
            np.random.MT19937(np.array(self._keys, dtype=np.uint32)))
        self.default_seeded = False

    def seed_default(self) -> None:
        """time + pid default-key seeding (QuEST_common.c:195-217), with
        the chosen keys logged so the run stays replayable."""
        # qlint: allow(nondeterminism): QuEST's documented default seed (time+pid); the keys are logged below and reported as DefaultSeed= by getEnvironmentString, so the run replays through seedQuEST
        self.seed([int(time.time()), os.getpid()])
        self.default_seeded = True
        print(json.dumps({"event": "quest_tpu_torch.rng.default_seed",
                          "seeds": self._keys}),
              file=sys.stderr, flush=True)

    def uniform(self) -> float:
        return float(self._rng.random_sample())

    def get_state(self) -> dict:
        """JSON-serialisable MT19937 state: restoring it with
        :meth:`set_state` continues the outcome stream exactly where it
        left off.  The JAX package's ``GLOBAL_RNG.get_state()`` gives the
        same dict for the same stream."""
        name, key, pos, has_gauss, cached = self._rng.get_state()
        return {
            "seeds": [int(k) for k in self._keys],
            "algo": name,
            "key": [int(x) for x in key],
            "pos": int(pos),
            "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached),
        }

    def set_state(self, state: dict) -> None:
        """Restore a snapshot from :meth:`get_state` (bit-exact stream
        continuation)."""
        self._keys = [int(k) & 0xFFFFFFFF for k in state["seeds"]]
        self._rng = np.random.RandomState(
            np.random.MT19937(np.array(self._keys, dtype=np.uint32)))
        self._rng.set_state((
            state.get("algo", "MT19937"),
            np.array(state["key"], dtype=np.uint32),
            int(state["pos"]),
            int(state["has_gauss"]),
            float(state["cached_gaussian"]),
        ))
        self.default_seeded = False


GLOBAL_RNG = _MeasurementRNG()
