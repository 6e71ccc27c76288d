"""Command line of the benchmark: one run of one cell.

    python3 -m wqlbench.run --workload crowd1m.local --seed 7 \\
        --seconds 30 --trace 0

prints the run's result as the last line of standard output: one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks`` comes last and holds
each number the check compared beside its limit, which also end
standard error. ``--rehearse K`` runs on the CPU with the crowd and the
batches divided by ``K`` and reports no measurement; ``--control cap64``
judges the reference kept to 64 recipients in the program's place (a
control that has to come out not correct).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m wqlbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", type=int, default=None, metavar="K")
    ap.add_argument("--control", choices=("cap64",), default=None)
    args = ap.parse_args(argv)
    from .harness import Refused, forbidden_modules, run_cell

    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_process=T_PROCESS,
                       rehearse=args.rehearse, control=args.control)
    except Refused as exc:
        print(f"wqlbench: {exc}", file=sys.stderr)
        return 2
    # last, after the window, the check and every metric reader: what
    # any of them loaded is in sys.modules now
    found = forbidden_modules()
    if found:
        print(f"wqlbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 2
    info = out.pop("info")
    print("wqlbench info " + json.dumps(info), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
