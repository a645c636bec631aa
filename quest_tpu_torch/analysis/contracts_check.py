"""Verify the ``@sharded_contract`` declarations against the exchange
calls each wrapper makes.

    python -m quest_tpu_torch.analysis.contracts_check [--device cuda:0]

Each wrapper in :data:`quest_tpu_torch.contracts.REQUIRED_WRAPPERS`
declares the exact collective histogram and a cap on the per-shard
payload of its canonical dispatch: the JAX package's configuration
(``quest_tpu/analysis/hlocheck.py`` canonical_cases: n = 10 state bits on
8 shards, float32, monolithic chunking), here on an in-process mesh of 8
shards (on the CPU, or all on one card).  ``introspect.audit`` runs each
dispatch once and counts the mesh's exchange calls by the reference's
opcode families; the check fails when:

* the histogram differs from the declaration;
* the largest payload per shard of the declared families exceeds
  ``max_exchange_bytes``;
* a contract declares per-tier caps and the largest payload on either
  tier exceeds its cap, the 8 shards read as 2 hosts x 4 chips (a
  permute's pairs crossing a host are "dcn"; a gather counts on both);
* a required wrapper carries no contract, or a contract names a wrapper
  that is not required.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Tuple

CANONICAL_N = 10          # state bits of the canonical dispatch
CANONICAL_SHARDS = 8      # r = 3 mesh bits
VERIFY_HOSTS = 2          # the per-tier caps read the mesh as 2 x 4
VERIFY_CHIPS = 4


def canonical_env(device: str = "cpu"):
    """The in-process mesh of 8 shards the canonical dispatches run on."""
    import quest_tpu_torch as tq

    return tq.createQuESTEnv(devices=[device] * CANONICAL_SHARDS)


def canonical_cases(env) -> Dict[str, Tuple[Callable, object, bool]]:
    """wrapper name -> (dispatch, sharded input, donate flag), the JAX
    package's cases: each wrapper's exchange path (a sharded target, a
    mesh bit, a bra mesh bit, a mixed local/mesh sigma) with chunks
    pinned to monolithic."""
    import numpy as np
    import torch

    from ..parallel import composites as COMP
    from ..parallel import dist as PAR
    from ..parallel import sharded as SH

    n = CANONICAL_N
    nloc = n - (CANONICAL_SHARDS.bit_length() - 1)

    def state(seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((2, 1 << n)).astype(np.float32)
        a /= np.sqrt((a ** 2).sum())
        return SH.split(env.mesh, a, nloc, torch.float32)

    h = (1 / np.sqrt(2)) * np.asarray([[1, 1], [1, -1]], np.float32)
    m = np.stack([h, np.zeros((2, 2), np.float32)])
    # bit 0 <-> bit n-1: one mixed local/mesh transposition
    sigma = PAR.canonical_sigma(
        (n - 1,) + tuple(range(1, n - 1)) + (0,))
    return {
        "apply_matrix_1q_sharded": (
            lambda a: PAR.apply_matrix_1q_sharded(
                a, m, num_qubits=n, target=n - 1, chunks=1),
            state(1), True),
        "swap_sharded": (
            lambda a: PAR.swap_sharded(
                a, num_qubits=n, qb_low=0, qb_high=n - 1, chunks=1),
            state(2), True),
        "gather_replicated": (
            lambda a: PAR.gather_replicated(a), state(3), False),
        "mix_pair_channel_sharded": (
            lambda a: COMP.mix_pair_channel_sharded(
                a, 0.3, num_qubits=n // 2, target=n // 2 - 1,
                kind="depol", chunks=1),
            state(4), True),
        "remap_sharded": (
            lambda a: PAR.remap_sharded(
                a, num_qubits=n, sigma=sigma, chunks=(1, 1)),
            state(5), True),
    }


def _payload_bytes(report, families) -> int:
    """Largest per-shard payload over the calls of ``families``."""
    return max((c["bytes"] for c in report.calls if c["op"] in families),
               default=0)


def _tier_bytes(report, families, chips: int) -> Dict[str, int]:
    """Largest per-shard payload on each tier, the mesh read as ``hosts
    x chips``: a permute rides DCN when any of its pairs crosses a host
    (``src ^ dst >= chips``); a call without pairs spans the mesh and
    counts on both tiers."""
    from ..parallel import topology

    best = {"ici": 0, "dcn": 0}
    for c in report.calls:
        if c["op"] not in families:
            continue
        if c["pairs"] is None:
            for tier in best:
                best[tier] = max(best[tier], c["bytes"])
            continue
        split = topology.split_pair_list(c["pairs"], chips)
        if not (split["ici"] or split["dcn"]):
            continue  # self-pairs only: nothing moves
        tier = "dcn" if split["dcn"] else "ici"
        best[tier] = max(best[tier], c["bytes"])
    return best


def verify_sharded_contracts(env=None, contracts=None) -> List[str]:
    """Run every canonical dispatch under the audit and diff it against
    its declaration.  Returns the failures (empty: all verified).
    ``contracts`` overrides the registry."""
    from .. import introspect
    from ..contracts import REQUIRED_WRAPPERS, SHARDED_CONTRACTS
    # the decorating modules must be imported for the registry to fill
    from ..parallel import composites as _composites  # noqa: F401
    from ..parallel import dist as _dist  # noqa: F401

    if env is None:
        env = canonical_env()
    if contracts is None:
        contracts = dict(SHARDED_CONTRACTS)
    errors: List[str] = []
    for name in REQUIRED_WRAPPERS:
        if name not in contracts:
            errors.append(f"{name}: required wrapper carries no "
                          "@sharded_contract declaration")
    for name in contracts:
        if name not in REQUIRED_WRAPPERS:
            errors.append(f"{name}: contract declared for a wrapper not in "
                          "contracts.REQUIRED_WRAPPERS")
    if errors:
        return errors
    cases = canonical_cases(env)
    for name in REQUIRED_WRAPPERS:
        decl = contracts[name]
        fn, amps, donate = cases[name]
        report = introspect.audit(fn, amps, donate=donate)
        measured = dict(report.collectives)
        if measured != dict(decl.collectives):
            errors.append(
                f"{name}: the canonical dispatch made {measured or '{}'} "
                f"but the @sharded_contract declares "
                f"{dict(decl.collectives)} ({CANONICAL_SHARDS} shards, "
                f"n={CANONICAL_N})")
            continue
        got = _payload_bytes(report, decl.collectives)
        if got > decl.max_exchange_bytes:
            errors.append(f"{name}: largest exchange payload is {got} B, "
                          f"over the declared max_exchange_bytes="
                          f"{decl.max_exchange_bytes}")
            continue
        if decl.max_tier_bytes:
            tiers = _tier_bytes(report, decl.collectives, VERIFY_CHIPS)
            for tier in sorted(decl.max_tier_bytes):
                cap = decl.max_tier_bytes[tier]
                if tiers.get(tier, 0) > cap:
                    errors.append(
                        f"{name}: {tier} payload is {tiers[tier]} B, over "
                        f"the declared max_tier_bytes[{tier}]={cap} (mesh "
                        f"read as {VERIFY_HOSTS}x{VERIFY_CHIPS})")
    return errors


def main(argv=None) -> int:
    import argparse

    from ..contracts import SHARDED_CONTRACTS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu",
                    help="the device all 8 shards live on (cpu, cuda:0)")
    args = ap.parse_args(argv)
    errors = verify_sharded_contracts(canonical_env(args.device))
    for e in errors:
        print(f"contracts: FAIL {e}")
    if errors:
        return 1
    for name, c in sorted(SHARDED_CONTRACTS.items()):
        tiers = (f" tiers<={dict(sorted(c.max_tier_bytes.items()))}"
                 if c.max_tier_bytes else "")
        print(f"contracts: ok {name} {dict(c.collectives)} "
              f"<= {c.max_exchange_bytes} B{tiers}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
