"""Command line of the port (counterpart of `drand_tpu/cli/main.py`'s
`util fsck`).

    python -m drand_tpu_torch.cli util fsck <store.db> [--repair] [--json]
        [--id BEACON_ID]

`util fsck` is the offline integrity check of a chain database: the
structural scan of `chain/recovery.py` (each row decoded, round
contiguity, previous-signature linkage) on binary and legacy JSON rows,
with no verifier, as drand_tpu's.  `--repair` quarantines the damaged
rows and rolls the tip back to the verified prefix.  Exit 0 on a clean
chain, 1 when damage was found, repaired or not.  The full BLS scan is
`chain.recovery.startup_recovery(store, ChainVerifier(...))`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m drand_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("util", help="operator utilities")
    sp.add_argument("--id", default="default", dest="beacon_id",
                    help="beacon id")
    sp.add_argument("what", choices=["fsck"])
    sp.add_argument("target", nargs="?", default="",
                    help="util fsck: the chain db path to scan")
    sp.add_argument("--repair", action="store_true",
                    help="util fsck: quarantine damaged rows and roll "
                    "the tip back to the verified prefix (nothing deleted)")
    sp.add_argument("--json", action="store_true", dest="json_out",
                    help="util fsck: machine-readable report on stdout")
    return p


async def cmd_fsck(args) -> int:
    if not args.target:
        raise SystemExit("util fsck needs a chain db path: "
                         "python -m drand_tpu_torch.cli util fsck "
                         "<store.db> [--repair] [--json]")
    if not os.path.exists(args.target):
        raise SystemExit(f"no such db: {args.target}")
    from drand_tpu_torch.chain.recovery import repair_store, scan_store
    from drand_tpu_torch.chain.store import SqliteStore
    store = SqliteStore(args.target)
    try:
        report = await scan_store(store, None, beacon_id=args.beacon_id)
        summary = None
        if args.repair and not report.ok:
            summary = repair_store(store, report)
        d = report.to_dict()
        if args.json_out:
            d["repair"] = summary
            print(json.dumps(d))
        else:
            print(f"scanned {report.scanned} rows "
                  f"(rounds {report.first_round}..{report.tip_round}) "
                  f"in {report.elapsed_s:.3f}s")
            for k in ("corrupt", "missing", "unlinked", "bad_sigs"):
                if d[k]:
                    print(f"  {k}: {d[k]}")
            if report.ok:
                print("chain OK")
            elif summary is not None:
                print(f"repaired: quarantined "
                      f"{summary['quarantined']} damaged + "
                      f"{summary['truncated']} rolled-back rows; "
                      f"tip now {summary['verified_tip']} "
                      f"(re-sync the suffix from peers)")
            else:
                print(f"DAMAGE FOUND (verified prefix ends at "
                      f"{report.verified_tip}); run with --repair "
                      f"to quarantine and roll back")
    finally:
        store.close()
    return 0 if report.ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(cmd_fsck(args))


if __name__ == "__main__":
    sys.exit(main())
