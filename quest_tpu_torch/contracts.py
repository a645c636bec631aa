"""Declarative sharded-collective contracts.

A copy of the JAX package's stdlib-only ``contracts.py`` (the port never
imports ``quest_tpu``).  Every sharded dispatch wrapper of the exchange
layer carries a declaration of its collective shape:

    @sharded_contract(collectives={"collective-permute": 1},
                      max_exchange_bytes=1 << 10)
    def swap_sharded(amps, *, num_qubits, qb_low, qb_high, ...):
        ...

``collectives`` pins the exact histogram of the wrapper's canonical
verification dispatch (the 8-shard in-process mesh configuration in
``analysis/contracts_check.py``) by the JAX package's opcode families:
where the JAX package reads the compiled HLO, the port counts the mesh's
exchange calls under ``introspect.audit`` (``Mesh.permute`` ->
``collective-permute``, ``gather`` / ``all_gather`` -> ``all-gather``,
``all_to_all`` -> ``all-to-all``, ``sum`` -> ``all-reduce``).
``max_exchange_bytes`` caps the largest per-shard payload of those
calls.  ``python -m quest_tpu_torch.analysis.contracts_check`` verifies
every declaration.

stdlib-only on purpose: parallel/dist.py imports this at module level.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShardedContract:
    """One wrapper's declared collective shape (see module docstring)."""

    name: str
    collectives: Dict[str, int]
    max_exchange_bytes: int
    # optional per-interconnect-tier byte caps ({"ici": .., "dcn": ..})
    # for the canonical dispatch with the 8-shard mesh read as 2 hosts x
    # 4 chips; None: only the flat max_exchange_bytes cap applies
    max_tier_bytes: Optional[Dict[str, int]] = None

    def as_dict(self) -> dict:
        out = {"name": self.name, "collectives": dict(self.collectives),
               "max_exchange_bytes": int(self.max_exchange_bytes)}
        if self.max_tier_bytes is not None:
            out["max_tier_bytes"] = {
                k: int(v) for k, v in self.max_tier_bytes.items()}
        return out


# name -> ShardedContract for every decorated wrapper, in decoration order
SHARDED_CONTRACTS: Dict[str, ShardedContract] = {}

# the sharded dispatch wrappers required to carry a contract, the JAX
# package's five (parallel/dist.py and, in the port, the pair channel's
# home parallel/composites.py)
REQUIRED_WRAPPERS = (
    "apply_matrix_1q_sharded",
    "swap_sharded",
    "gather_replicated",
    "mix_pair_channel_sharded",
    "remap_sharded",
)


def sharded_contract(*, collectives: Dict[str, int],
                     max_exchange_bytes: int,
                     max_tier_bytes: Optional[Dict[str, int]] = None,
                     name: Optional[str] = None) -> Callable:
    """Declare a sharded dispatch wrapper's collective contract: registers
    it in :data:`SHARDED_CONTRACTS` and attaches it to the function as
    ``__sharded_contract__``.  Purely declarative: nothing runs at
    dispatch time."""
    decl_collectives = {str(k): int(v) for k, v in collectives.items()}
    decl_tier = (None if max_tier_bytes is None
                 else {str(k): int(v) for k, v in max_tier_bytes.items()})

    def deco(fn: Callable) -> Callable:
        contract = ShardedContract(
            name=name or fn.__name__,
            collectives=decl_collectives,
            max_exchange_bytes=int(max_exchange_bytes),
            max_tier_bytes=decl_tier,
        )
        SHARDED_CONTRACTS[contract.name] = contract
        fn.__sharded_contract__ = contract
        return fn

    return deco
