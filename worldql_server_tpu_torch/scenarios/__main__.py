"""Scenario CLI: ``python -m worldql_server_tpu_torch.scenarios [names...]``.

Runs catalog scenarios back to back (each on a fresh server + event
loop) and prints their reports; ``--check`` exits 1 if any declared
survival/SLO check fails — the CI "Scenario smoke" gate. ``--json``
emits one report per line for machine consumers.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import CATALOG, format_report, run_scenario


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m worldql_server_tpu_torch.scenarios",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("names", nargs="*", default=[],
                   help=f"scenarios to run (default: all of "
                        f"{', '.join(sorted(CATALOG))})")
    p.add_argument("--shape", choices=["smoke", "full"], default="smoke",
                   help="workload sizing (smoke = 1-core CI seconds)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 when any scenario check fails")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON report per line")
    args = p.parse_args(argv)

    # default = the CI-smoke set; slow/special scenarios (ci_smoke =
    # False, e.g. reconnect_storm_replay) run by explicit name only
    names = args.names or sorted(
        n for n in CATALOG if CATALOG[n].ci_smoke
    )
    unknown = [n for n in names if n not in CATALOG]
    if unknown:
        p.error(f"unknown scenario(s): {', '.join(unknown)} "
                f"(have: {', '.join(sorted(CATALOG))})")

    failed = 0
    for name in names:
        report = run_scenario(name, shape=args.shape)
        failed += report["checks_failed"]
        if args.json:
            print(json.dumps(report))
        else:
            print(format_report(report))
    if args.check and failed:
        print(f"scenario suite: {failed} failed check(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
