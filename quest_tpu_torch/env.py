"""Execution environment: the shards' devices, the mesh and the seeding.

Analogue of the reference's ``QuESTEnv`` (QuEST.h:361, {rank, numRanks})
and ``createQuESTEnv`` (MPI_Init + rank discovery,
QuEST_cpu_distributed.c:129-160; GPU probe, QuEST_gpu.cu:446-478).  An
env holds R = 2^r shard devices: a register's amplitudes split over them
by their leading index bits (parallel/mesh.py).  ``createQuESTEnv()``
takes one shard per visible CUDA card, truncated to a power of two (on a
one-card machine, a one-shard env), and raises when there is no card; the
CPU is used only when asked for (``device="cpu"``, or ``devices=["cpu"]
* R`` for an in-process mesh on the CPU, as the tests do).  After
``initDistributed`` an env holds one shard per torch.distributed rank.
A one-shard env holds no mesh, and everything runs on its one device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

from . import rng
from .validation import QuESTError


@dataclasses.dataclass
class QuESTEnv:
    """The shard devices and the measurement streams' keys.

    ``device`` is this process's device (shard 0's in process, the rank's
    own under torch.distributed); ``devices`` lists every shard's device
    (repeats allowed); ``mesh`` moves data between them (None for one
    shard); ``rank`` / ``num_ranks`` follow the JAX package's env: the
    process's rank and the number of shards.  ``topology`` is the hosts x
    devices arrangement (parallel/topology.py).  ``seeds`` are the
    measurement streams' keys (seedQuEST)."""

    device: torch.device
    rank: int = 0
    num_ranks: int = 1
    seeds: tuple = ()
    devices: Tuple[torch.device, ...] = ()
    mesh: Optional[object] = None
    topology: Optional[object] = None

    def __post_init__(self):
        if not self.devices:
            self.devices = (self.device,)

    @property
    def num_devices(self) -> int:
        return len(self.devices)


def _pow2_prefix(devs: list) -> list:
    return devs[:1 << (len(devs).bit_length() - 1)] if devs else devs


def create_quest_env(device=None, num_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> QuESTEnv:
    """createQuESTEnv (QuEST.h:1851).

    * ``devices=[...]``: one shard per entry (repeats allowed: an
      in-process mesh of R shards on one device), the counterpart of the
      JAX package's virtual device count;
    * ``device=...``: one shard on that device;
    * neither: after ``initDistributed``, one shard per rank on this
      rank's device; else one shard per visible CUDA card, and a
      QuESTError when there is none (no silent fall-back to the CPU).

    ``num_devices`` truncates the list, and the list is truncated to a
    power of two: shards split the index on its bits (validateNumRanks,
    QuEST_validation.c:331-343)."""
    from .parallel import topology as topo

    if devices is None and device is None and _dist_active():
        return _create_dist_env(num_devices)
    if devices is None:
        if device is None:
            if not torch.cuda.is_available():
                raise QuESTError(
                    "createQuESTEnv: no CUDA device is available; pass "
                    "device=\"cpu\" to run on the CPU explicitly.")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            devices = [device]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise QuESTError("createQuESTEnv: the device list is empty.")
    if num_devices is not None:
        devs = devs[:int(num_devices)]
    devs = _pow2_prefix(devs)
    mesh = None
    if len(devs) > 1:
        from .parallel.mesh import InProcessMesh

        mesh = InProcessMesh(devs)
    env = QuESTEnv(device=devs[0], rank=0, num_ranks=len(devs),
                   devices=tuple(devs), mesh=mesh,
                   topology=topo.resolve(len(devs)))
    seed_quest_default(env)
    return env


def _dist_active() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _create_dist_env(num_devices: Optional[int]) -> QuESTEnv:
    """One shard per torch.distributed rank, on cuda:<local rank> under
    NCCL, on the CPU under gloo."""
    import torch.distributed as dist

    from .parallel import topology as topo
    from .parallel.mesh import DistMesh

    world = dist.get_world_size()
    rank = dist.get_rank()
    if num_devices is not None and int(num_devices) != world:
        raise QuESTError(
            "createQuESTEnv: under torch.distributed the env holds one "
            f"shard per rank ({world}), not {num_devices}.")
    if world & (world - 1):
        raise QuESTError(
            f"createQuESTEnv: {world} ranks is not a power of two.")
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device(f"cuda:{local}")
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    mesh = DistMesh(device, world, rank) if world > 1 else None
    env = QuESTEnv(device=device, rank=rank, num_ranks=world,
                   devices=tuple(device for _ in range(world)), mesh=mesh,
                   topology=topo.resolve(world))
    seed_quest_default(env)
    return env


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """initDistributed: join a multi-process run, the analogue of the
    reference's ``MPI_Init`` (QuEST_cpu_distributed.c:129-160) and of the
    JAX package's ``jax.distributed.initialize``.  Call once per process
    before ``createQuESTEnv``; the env then holds one shard per rank.
    ``init_method`` (e.g. ``"tcp://localhost:29500"``), ``world_size`` and
    ``rank`` default to torch.distributed's environment variables;
    ``backend`` defaults to NCCL, which needs a CUDA card per rank: with
    no card it raises rather than fall back to gloo on the CPU (pass
    ``backend="gloo"`` for that)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise QuESTError(
                "initDistributed: no CUDA device is available for the "
                "default NCCL backend; pass backend=\"gloo\" to run on "
                "the CPU explicitly.")
        backend = "nccl"
    kwargs = {}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(backend=backend, **kwargs)


def shrink_env(env: QuESTEnv, num_devices: int, *,
               exclude_index: Optional[int] = None,
               exclude_indices: Optional[Sequence[int]] = None) -> QuESTEnv:
    """A degraded env over a power-of-two subset of ``env``'s shard
    devices: the mesh half of the elastic failover (resilience._failover)
    and of loadQureg's load onto a grown mesh (quest_tpu/env.py
    shrink_env).  ``exclude_index`` drops one shard (the presumed-dead
    one) before truncating, ``exclude_indices`` a set (a dead host's
    whole range, topology.host_range).  On one card an in-process mesh
    of R shards shrinks to the surviving shards' devices, still on that
    card.  The seeds are kept without reseeding: the measurement
    streams belong to the run, and a failover restores them from the
    checkpoint.  The topology is topology.shrink's."""
    from .parallel import topology as topo
    from .parallel.mesh import InProcessMesh

    dead = set() if exclude_indices is None else {
        int(i) for i in exclude_indices}
    if exclude_index is not None:
        dead.add(int(exclude_index))
    devs = [d for i, d in enumerate(env.devices) if i not in dead]
    num_devices = int(num_devices)
    if num_devices < 1 or num_devices & (num_devices - 1):
        raise ValueError(
            f"shrink_env: num_devices must be a positive power of two, "
            f"got {num_devices}")
    if num_devices > len(devs):
        raise ValueError(
            f"shrink_env: asked for {num_devices} devices but only "
            f"{len(devs)} survive in this environment")
    if env.mesh is not None and not isinstance(env.mesh, InProcessMesh):
        raise QuESTError(
            "shrink_env: an env of torch.distributed ranks cannot shrink "
            "in process; restart on the surviving ranks")
    devs = devs[:num_devices]
    mesh = InProcessMesh(devs) if num_devices > 1 else None
    return QuESTEnv(device=devs[0], rank=0, num_ranks=num_devices,
                    seeds=env.seeds, devices=tuple(devs), mesh=mesh,
                    topology=topo.shrink(env.topology, num_devices))


def destroy_quest_env(env: QuESTEnv) -> None:
    """destroyQuESTEnv (QuEST.h:1864): nothing to free."""


def sync_quest_env(env: QuESTEnv) -> None:
    """syncQuESTEnv (QuEST.h:1875): wait for every shard device's queued
    work."""
    for dev in sorted({d for d in env.devices if d.type == "cuda"},
                      key=str):
        torch.cuda.synchronize(dev)


def sync_quest_success(success_code: int = 1) -> int:
    """syncQuESTSuccess (QuEST_cpu_distributed.c:166-170) AND-reduces a
    flag across ranks; one process returns it unchanged."""
    return int(success_code)


def get_environment_string(env: QuESTEnv) -> str:
    """getEnvironmentString (QuEST.h:1912): device, precision and seeds;
    while the measurement streams are on their time+pid default seed, the
    chosen keys as ``DefaultSeed=``, so the run replays with
    ``seedQuEST(env, <keys>)``; then the degradations and the telemetry
    block (``_health_fragment``)."""
    from . import precision

    if env.device.type == "cuda":
        name = torch.cuda.get_device_name(env.device)
    else:
        name = "cpu"
    return (f"EnvType=quest_tpu_torch Backend={env.device.type} "
            f"Device={name} Devices={env.num_devices} "
            + (f"Mesh={env.mesh.describe()} " if env.mesh is not None
               else "")
            + f"Precision={precision.get_precision()} "
            f"Seeds={','.join(str(s) for s in env.seeds)}"
            + (" DefaultSeed=" + ",".join(str(k) for k in
                                          rng.GLOBAL_RNG._keys)
               if rng.GLOBAL_RNG.default_seeded else "")
            + _health_fragment(env))


def _health_fragment(env: QuESTEnv) -> str:
    """The degradation report and the telemetry block appended to
    getEnvironmentString (quest_tpu/env.py:340-424): degradations,
    failovers and exchange timeouts, the peak device-memory watermark,
    the memory governor's policy and budget on ``env``, the circuit
    optimizer, the permutation and megakernel routes, and
    ``[telemetry: ...]``."""
    from . import governor, optimizer, resilience, telemetry
    from .parallel import dist

    s = f" ExchangeChunks={dist.exchange_config_key() or 'auto'}"
    degraded = resilience.degradation_report()
    if degraded:
        s += " Degraded=[" + "; ".join(
            f"{k}: {v}" for k, v in sorted(degraded.items())) + "]"
    failovers = telemetry.counter_total("failovers_total")
    if failovers:
        s += f" Failovers={int(failovers)}"
    timeouts = telemetry.counter_total("exchange_timeouts_total")
    if timeouts:
        s += f" ExchangeTimeouts={int(timeouts)}"
    peak = telemetry.gauge_max("hbm_watermark_bytes")
    if peak is not None:
        s += f" HbmPeak={int(peak)}"
    if governor.enabled(env):
        s += (f" MemGovernor={governor.policy()}"
              f"(budget={governor.budget_bytes(env)}"
              f" resident={governor.resident_bytes()})")
    s += f" {optimizer.summary_line()}"
    for name, label, routes in (
            ("permutation_gates_total", "PermFast",
             ("relabel", "gather", "exchange")),
            ("megakernel_dispatch_total", "Megakernel",
             ("mega", "fallback"))):
        if telemetry.counter_total(name):
            s += f" {label}=" + ",".join(
                f"{r}:{int(telemetry.counter_sum(name, route=r))}"
                for r in routes if telemetry.counter_sum(name, route=r))
    return s + f" [telemetry: {telemetry.summary()}]"


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
