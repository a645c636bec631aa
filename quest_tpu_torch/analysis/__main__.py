"""qlint CLI of the port: ``python -m quest_tpu_torch.analysis [paths...]
[options]``.

Exit codes:
  0  clean — no unsuppressed findings (and contracts verified, if
     ``--contracts``)
  1  findings / contract drift — each printed as
     ``path:line:col: <rule-id> <message>``
  2  usage or environment error (bad baseline, ...)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import engine


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m quest_tpu_torch.analysis",
        description="qlint for the port: layering, collective "
                    "confinement, hygiene and sharded-contract checks")
    p.add_argument("paths", nargs="*",
                   help="files/directories to walk (default: "
                        + ", ".join(engine.DEFAULT_WALK) + ")")
    p.add_argument("--rules", metavar="ID[,ID...]",
                   help="run only these rule ids")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    p.add_argument("--baseline", default=engine.BASELINE_DEFAULT,
                   help="grandfathered-findings file "
                        "(default: quest_tpu_torch/analysis/"
                        "baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline from the current findings "
                        "(explicit grandfathering) and exit")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON")
    p.add_argument("--contracts", action="store_true",
                   help="also verify @sharded_contract declarations "
                        "against the exchange calls of their canonical "
                        "dispatches (8 in-process shards on the CPU)")
    args = p.parse_args(argv)

    t0 = time.monotonic()
    rules = engine.all_rules()
    if args.list_rules:
        for rid in sorted(rules):
            r = rules[rid]
            where = ("everywhere" if r.scope is None
                     else "|".join(r.scope))
            print(f"{rid:24s} [{where}] {r.doc}")
        return 0

    selected = None
    if args.rules:
        selected = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in selected if r not in rules]
        if unknown:
            print(f"qlint: unknown rule id(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2

    walk = tuple(args.paths) if args.paths else engine.DEFAULT_WALK
    findings = engine.analyze_paths(walk, rules=selected)

    if args.write_baseline:
        engine.write_baseline(findings, args.baseline)
        print(f"qlint: wrote {len(findings)} grandfathered finding(s) "
              f"to {args.baseline} — fill in per-entry reasons before "
              f"committing")
        return 0

    baseline = []
    if not args.no_baseline:
        try:
            baseline = engine.load_baseline(args.baseline)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"qlint: baseline error: {e}", file=sys.stderr)
            return 2
    new, grandfathered, stale = engine.apply_baseline(findings, baseline)

    if args.json:
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "grandfathered": [vars(f) for f in grandfathered],
            "stale_baseline": stale,
        }, indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.format())
        for e in stale:
            print(f"qlint: stale baseline entry {e['path']}:{e['line']} "
                  f"({e['rule']}) no longer fires — delete it from "
                  f"{args.baseline}")

    rc = 0
    if new or stale:
        rc = 1

    if args.contracts:
        from . import contracts_check
        crc = contracts_check.main([])
        rc = max(rc, crc)

    if not args.json:
        dt = time.monotonic() - t0
        n_files = sum(1 for _ in engine.iter_python_files(walk))
        print(f"qlint: {len(new)} finding(s), "
              f"{len(grandfathered)} grandfathered, {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'} over "
              f"{n_files} files in {dt:.1f}s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
