"""The amplitude mesh and its transport.

A register on an env of R = 2^r shards holds its amplitudes as R shard
tensors of shape ``(2, 2^nloc)``, nloc = n - r: shard s holds the global
amplitude indices ``[s * 2^nloc, (s + 1) * 2^nloc)``, the JAX package's
leading-bit split (quest_tpu/env.py's NamedSharding over the amplitude
axis).  A mesh moves data between shards through a handful of
operations, with two backends:

* ``InProcessMesh``: every shard lives in this process, shard s on
  ``devices[s]`` (devices may repeat: R shards on one card, or on the
  CPU).  A permute is a copy of each sent tensor into a receive buffer
  on the destination's device (a peer copy where the devices differ).
* ``DistMesh``: one shard per ``torch.distributed`` rank, on the rank's
  device.  Pairwise exchanges go through ``batch_isend_irecv``, sums
  through ``all_reduce``, the block transpose through
  ``all_to_all_single`` and the gathers through ``all_gather``: NCCL
  carries them between cards, gloo on the CPU.

Shard lists are always aligned with ``mesh.local``, the shard indices this
process holds (all R in process, its own rank under torch.distributed).
``ShardedAmps`` is the carrier a sharded register holds, or a sharded
register bank (``batch.BatchedQureg``), whose shards are ``(B, 2,
2^nloc)``: every element's slice of the same global index range, the
batch axis outermost.  It is not a tensor: arithmetic, indexing or a
NumPy conversion raises a QuESTError naming what to call instead,
rather than gathering the register.

The models (``models/vqe.py``, ``models/qaoa.py``) differentiate through
a mesh: ``exchange``, ``sum_grad`` and ``replicate`` are the
out-of-place, autograd-aware forms of ``permute`` and ``sum``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..validation import QuESTError


def _api_caller() -> Optional[str]:
    """The outermost public API function on the call stack, if any."""
    import sys

    f = sys._getframe(2)
    name = None
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod in ("quest_tpu_torch.api", "quest_tpu_torch.api_ops") \
                and not f.f_code.co_name.startswith("_"):
            name = f.f_code.co_name
        f = f.f_back
    return name


def refusal(what: str) -> QuESTError:
    """The error a tensor operation on sharded amplitudes raises, naming
    the API function that reached it and what to call instead."""
    caller = _api_caller()
    if caller is not None:
        what = f"{caller}: {what}"
    return QuESTError(
        f"{what}: the amplitudes of a register split over several shards "
        "are a carrier of its shard tensors, not a tensor; read them "
        "through the API's read functions (calcTotalProb, getAmp, "
        "calcInnerProduct, ...), or take a host copy of the whole state "
        "with interop.register_state(qureg, canonical=True).")


class Mesh:
    """The interface both backends implement."""

    devices: Tuple[torch.device, ...]
    local: Tuple[int, ...]

    @property
    def axis_size(self) -> int:
        return len(self.devices)

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard]

    def permute(self, sends: Sequence[Optional[torch.Tensor]],
                pairs: Sequence[Tuple[int, int]]) -> List[Optional[torch.Tensor]]:
        """``sends[k]`` is what local shard ``local[k]`` sends along its
        (src, dst) pair; returns, per local shard, the tensor it received
        (None where it is no destination), each a new buffer on the
        receiver's device."""
        raise NotImplementedError

    def sum(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of its partial (the local partials
        given, aligned with ``local``): one value, the same on every
        shard, on the first local shard's device."""
        raise NotImplementedError

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole register, the shards concatenated along the last
        axis in shard order, on the first local shard's device."""
        raise NotImplementedError

    def all_to_all(self, blocks: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``blocks[k]`` is local shard ``local[k]``'s (R, ...) tensor of R
        equal blocks; block j goes to shard j.  Returns, per local shard
        s, a new (R, ...) tensor on its device whose block i is what
        shard i sent to s (the JAX package's untiled ``lax.all_to_all``).
        A caller that chunks the exchange calls it once per chunk."""
        raise NotImplementedError

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's small tensor ``parts[k]`` (equal shapes)
        concatenated along dim 0 in shard order, on the first local
        shard's device (a replicated operand or the per-shard partials;
        never a register)."""
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def barrier(self) -> None:
        """Return once every process holding shards of this mesh has
        called it (the ranks of a checkpoint meet here between its
        phases); one process holds them all in process."""
        raise NotImplementedError

    # -- the differentiable forms (the models' state on a mesh) ----------

    def exchange(self, sends: Sequence[torch.Tensor],
                 pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``permute`` out of place and under autograd: the gradient of
        what a shard received flows back to its sender (the reverse
        exchange)."""
        raise NotImplementedError

    def sum_grad(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """``sum`` under autograd: every shard's partial receives the
        gradient of the (replicated) total."""
        raise NotImplementedError

    def replicate(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a tensor every process holds alike (the parameters),
        as the shards' operand: its gradient is summed over every
        process's shards."""
        raise NotImplementedError


class InProcessMesh(Mesh):
    """R shards held by this process, shard s on ``devices[s]``."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        self.local = tuple(range(len(self.devices)))

    def permute(self, sends, pairs):
        out: List[Optional[torch.Tensor]] = [None] * len(self.devices)
        # every receive buffer is filled before any caller writes a shard:
        # a shard's own data stays intact until its partner has read it
        for src, dst in pairs:
            out[dst] = sends[src].to(self.devices[dst], copy=True)
        return out

    def sum(self, partials):
        dev = self.devices[0]
        total = partials[0].to(dev)
        for p in partials[1:]:
            total = total + p.to(dev)
        return total

    def gather(self, shards):
        dev = self.devices[0]
        return torch.cat([s.to(dev) for s in shards], dim=-1)

    def all_to_all(self, blocks):
        # every output is built before the caller rebinds any shard
        return [torch.stack([blocks[i][s].to(self.devices[s], copy=True)
                             for i in range(len(self.devices))])
                for s in range(len(self.devices))]

    def all_gather(self, parts):
        dev = self.devices[0]
        return torch.cat([p.to(dev) for p in parts], dim=0)

    def describe(self) -> str:
        names = sorted({str(d) for d in self.devices})
        return f"in-process x{len(self.devices)} on {','.join(names)}"

    def barrier(self) -> None:
        pass

    # one autograd graph holds every shard: .to() and + are differentiable

    def exchange(self, sends, pairs):
        return self.permute(sends, pairs)

    def sum_grad(self, partials):
        return self.sum(partials)

    def replicate(self, t):
        return t


class DistMesh(Mesh):
    """One shard per torch.distributed rank; ``device`` is this rank's."""

    def __init__(self, device, world_size: int, rank: int, group=None):
        import torch.distributed as dist

        self.device = torch.device(device)
        self.rank = int(rank)
        self.group = group
        # every rank joins one collective first: NCCL leaves a first
        # batch_isend_irecv that some ranks skip undefined
        dist.barrier(group=group)
        # every rank's device is reported as this rank's own kind: a rank
        # only ever touches its own shard
        self.devices = tuple(self.device for _ in range(int(world_size)))
        self.local = (self.rank,)

    def permute(self, sends, pairs):
        import torch.distributed as dist

        me = self.rank
        send = sends[0]
        ops, recv = [], None
        for src, dst in pairs:
            if src == me and dst == me:
                return [send.to(self.device, copy=True)]
        for src, dst in pairs:
            if src == me:
                ops.append(dist.P2POp(dist.isend, send.contiguous(), dst,
                                      group=self.group))
            if dst == me:
                recv = torch.empty(send.shape, dtype=send.dtype,
                                   device=self.device)
                ops.append(dist.P2POp(dist.irecv, recv, src,
                                      group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [recv]

    def sum(self, partials):
        import torch.distributed as dist

        t = partials[0].to(self.device).clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def gather(self, shards):
        import torch.distributed as dist

        mine = shards[0].contiguous()
        parts = [torch.empty_like(mine) for _ in self.devices]
        dist.all_gather(parts, mine, group=self.group)
        return torch.cat(parts, dim=-1)

    def all_to_all(self, blocks):
        import torch.distributed as dist

        mine = blocks[0].contiguous()
        out = torch.empty_like(mine)
        dist.all_to_all_single(out, mine, group=self.group)
        return [out]

    def all_gather(self, parts):
        import torch.distributed as dist

        mine = parts[0].to(self.device).contiguous()
        out = torch.empty((len(self.devices) * mine.shape[0],)
                          + tuple(mine.shape[1:]), dtype=mine.dtype,
                          device=self.device)
        dist.all_gather_into_tensor(out, mine, group=self.group)
        return out

    def describe(self) -> str:
        import torch.distributed as dist

        return (f"torch.distributed x{len(self.devices)} "
                f"({dist.get_backend(self.group)}) on {self.device}")

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)

    # every rank runs the same graph, so the backward passes' collectives
    # meet in the same order on every rank

    def exchange(self, sends, pairs):
        return [_DistExchange.apply(sends[0], self, tuple(pairs))]

    def sum_grad(self, partials):
        return _DistSum.apply(partials[0].to(self.device), self)

    def replicate(self, t):
        return _DistReplicate.apply(t, self)


class _DistExchange(torch.autograd.Function):
    """A rank's part of a pairwise exchange; backward sends each received
    gradient back to its sender."""

    @staticmethod
    def forward(ctx, x, mesh, pairs):
        ctx.mesh, ctx.pairs = mesh, pairs
        return mesh.permute([x], pairs)[0]

    @staticmethod
    def backward(ctx, g):
        back = tuple((dst, src) for src, dst in ctx.pairs)
        return ctx.mesh.permute([g.contiguous()], back)[0], None, None


class _DistSum(torch.autograd.Function):
    """all_reduce of the partials; each rank's partial takes the gradient
    of the total that every rank holds alike (one loss, seeded on every
    rank), unchanged."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.sum([x])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DistReplicate(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the ranks, so
    every rank's copy of the parameters gets the whole gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum([g]), None


class _LostShards:
    """The shard list of a register whose in-place exchange failed part
    way (some shards or chunks updated, others not): every use raises
    that failure again, as a donated buffer of the JAX package does once
    its dispatch has died."""

    __slots__ = ("err",)

    def __init__(self, err: Exception):
        self.err = err

    def _lost(self, *args, **kwargs):
        raise self.err

    __getitem__ = __setitem__ = __iter__ = __len__ = _lost


class ShardedAmps:
    """The amplitudes of a register split over a mesh: ``shards`` holds
    the local shards' ``(2, 2^nloc)`` tensors, aligned with ``mesh.local``
    (a bank's: ``(B, 2, 2^nloc)``, ``batch_size`` B).

    It carries the metadata the drain and the reads need (``dtype``,
    ``device``, ``nloc``, ``itemsize``, ``batch_size``) and nothing of a
    tensor's interface: a torch function, an indexing, a NumPy conversion
    or any other tensor attribute raises a QuESTError naming the read
    functions and ``interop.register_state``, so nothing gathers a
    register silently."""

    __slots__ = ("mesh", "shards")

    def __init__(self, mesh: Mesh, shards: Sequence[torch.Tensor]):
        self.mesh = mesh
        self.shards = list(shards)

    def mark_lost(self, err: Exception) -> None:
        """Refuse every later use of these amplitudes with ``err``."""
        self.shards = _LostShards(err)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nloc(self) -> int:
        return int(self.shards[0].shape[-1]).bit_length() - 1

    @property
    def itemsize(self) -> int:
        """Bytes of one real value (an element's shard holds 2 x 2^nloc)."""
        return self.shards[0].element_size()

    @property
    def batch_size(self) -> int:
        """B of a bank's (B, 2, 2^nloc) shards; 0 for one register."""
        sh = self.shards[0]
        return int(sh.shape[0]) if sh.dim() == 3 else 0

    def element(self, i: int) -> "ShardedAmps":
        """Bank element ``i`` as a register's ShardedAmps (views of the
        bank's shards)."""
        return ShardedAmps(self.mesh, [s[int(i)] for s in self.shards])

    def __getattr__(self, name):
        raise refusal(f"tensor attribute {name!r} of sharded amplitudes")

    def __getitem__(self, key):
        raise refusal("indexing sharded amplitudes")

    def __setitem__(self, key, value):
        raise refusal("writing into sharded amplitudes")

    def __iter__(self):
        raise refusal("iterating over sharded amplitudes")

    def __len__(self):
        raise refusal("len() of sharded amplitudes")

    def __array__(self, *args, **kwargs):
        raise refusal("converting sharded amplitudes to NumPy")

    def __float__(self):
        raise refusal("float() of sharded amplitudes")

    def _arith(self, *args):
        raise refusal("arithmetic on sharded amplitudes")

    # Python finds these on the type, never through __getattr__
    __add__ = __radd__ = __sub__ = __rsub__ = _arith
    __mul__ = __rmul__ = __matmul__ = __rmatmul__ = _arith
    __truediv__ = __rtruediv__ = __pow__ = __rpow__ = _arith
    __neg__ = __pos__ = __abs__ = _arith

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        raise refusal(f"torch.{name} on sharded amplitudes")

    def __repr__(self) -> str:
        bank = f"{self.batch_size} x " if self.batch_size else ""
        return (f"ShardedAmps({self.mesh.axis_size} shards of "
                f"{bank}2^{self.nloc}, {self.dtype})")
