"""Execution environment: one device and the seeding bookkeeping.

Analogue of the reference's ``QuESTEnv`` (QuEST.h:361, {rank, numRanks})
and ``createQuESTEnv`` (GPU probe, QuEST_gpu.cu:446-478) for a single
device.  ``createQuESTEnv()`` binds the CUDA card and raises when there is
none; the CPU is used only when the caller asks for it with
``createQuESTEnv(device="cpu")`` (the tests do).  Multi-device sharding
arrives with the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from . import rng
from .validation import QuESTError


@dataclasses.dataclass
class QuESTEnv:
    """One device.  ``rank``/``num_ranks`` are kept for reference-API
    parity (one process, one device).  ``seeds`` are the measurement
    streams' keys (seedQuEST)."""

    device: torch.device
    rank: int = 0
    num_ranks: int = 1
    seeds: tuple = ()

    @property
    def num_devices(self) -> int:
        return 1


def create_quest_env(device=None) -> QuESTEnv:
    """createQuESTEnv (QuEST.h:1851).  ``device=None`` means the CUDA card
    and raises a QuESTError when no CUDA device is present: there is no
    silent fall-back to the CPU.  Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise QuESTError(
                "createQuESTEnv: no CUDA device is available; pass "
                "device=\"cpu\" to run on the CPU explicitly.")
        device = "cuda"
    env = QuESTEnv(device=torch.device(device))
    seed_quest_default(env)
    return env


def destroy_quest_env(env: QuESTEnv) -> None:
    """destroyQuESTEnv (QuEST.h:1864): nothing to free."""


def sync_quest_env(env: QuESTEnv) -> None:
    """syncQuESTEnv (QuEST.h:1875): wait for the device's queued work."""
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)


def sync_quest_success(success_code: int = 1) -> int:
    """syncQuESTSuccess (QuEST_cpu_distributed.c:166-170) AND-reduces a
    flag across ranks; one process returns it unchanged."""
    return int(success_code)


def get_environment_string(env: QuESTEnv) -> str:
    """getEnvironmentString (QuEST.h:1912): device, precision and seeds;
    while the measurement streams are on their time+pid default seed, the
    chosen keys as ``DefaultSeed=``, so the run replays with
    ``seedQuEST(env, <keys>)``."""
    from . import precision

    if env.device.type == "cuda":
        name = torch.cuda.get_device_name(env.device)
    else:
        name = "cpu"
    return (f"EnvType=quest_tpu_torch Backend={env.device.type} "
            f"Device={name} Devices={env.num_devices} "
            f"Precision={precision.get_precision()} "
            f"Seeds={','.join(str(s) for s in env.seeds)}"
            + (" DefaultSeed=" + ",".join(str(k) for k in
                                          rng.GLOBAL_RNG._keys)
               if rng.GLOBAL_RNG.default_seeded else ""))


def seed_quest(env: QuESTEnv, seeds: Sequence[int]) -> None:
    """seedQuEST (QuEST.h:3341): seed both measurement streams, the host
    Mersenne Twister (rng.GLOBAL_RNG) and the threefry key
    (ops/measurement.KEYS), from the same seeds as the JAX package."""
    from .ops import measurement

    env.seeds = tuple(int(s) for s in seeds)
    rng.GLOBAL_RNG.seed(env.seeds)
    measurement.KEYS.seed(env.seeds)


def seed_quest_default(env: QuESTEnv) -> None:
    """seedQuESTDefault (QuEST.h:3324): the time+pid key, logged."""
    from .ops import measurement

    rng.GLOBAL_RNG.seed_default()
    env.seeds = tuple(rng.GLOBAL_RNG._keys)
    measurement.KEYS.seed(env.seeds)
