"""CLI: run the chaos-scenario matrix and report liveness.

    python -m stellar_tpu_torch.scenarios [--matrix small|big] [--only CLS[,CLS]]
                                    [--seed N] [--json] [--signature-backend gpu|cpu]

One line per scenario; exits nonzero when ANY scenario fails — invariant
violation, chain disagreement, liveness-floor miss, unrecovered heal, or
a polluted verify cache under flood.  This is the relay_watch
``scenario_liveness_r12`` step's entry point.

The storage plane's sweep (relay_watch ``crash_sweep_r18``):

    python -m stellar_tpu_torch.scenarios --kill-sweep [--points P[,P]]
                                    [--modes exit|all] [--target N] [--json]

hard-kills a standalone node at every registered durable-write
kill-point it crosses in a close+publish window (one subprocess per
point × fault mode; scenarios/killsweep.py) and exits 1 on ANY
unrecovered point or post-repair hash mismatch.  ``--kill-child`` is
the internal per-leg entry point those subprocesses run.
"""

from __future__ import annotations

import argparse
import json
import sys

from .matrix import FAULT_CLASSES, run_matrix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stellar_tpu_torch.scenarios")
    ap.add_argument("--matrix", choices=("small", "big"), default="small")
    ap.add_argument(
        "--only",
        help="comma-separated fault classes (%s)" % ",".join(FAULT_CLASSES),
    )
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--json", action="store_true", dest="as_json")
    # every node's Config.SIGNATURE_BACKEND, in the matrix and the kill
    # sweep's children; by default each spec's own, else the test
    # config's ("gpu", on the card)
    ap.add_argument("--signature-backend", choices=("gpu", "cpu"),
                    dest="signature_backend")
    # kill-sweep mode (scenarios/killsweep.py)
    ap.add_argument("--kill-sweep", action="store_true", dest="kill_sweep")
    ap.add_argument("--points", help="comma-separated kill-point names")
    ap.add_argument("--modes", choices=("exit", "all"), default="all")
    ap.add_argument("--target", type=int, default=None)
    ap.add_argument("--keep", action="store_true")
    # internal: one sweep leg (the subprocess the sweep spawns)
    ap.add_argument("--kill-child", action="store_true", dest="kill_child")
    ap.add_argument("--workdir")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    if args.kill_child:
        from .killsweep import DEFAULT_TARGET, child_main

        return child_main(
            args.workdir, args.target or DEFAULT_TARGET, args.out,
            args.signature_backend,
        )
    if args.kill_sweep:
        from .killsweep import DEFAULT_TARGET, run_kill_sweep

        points = args.points.split(",") if args.points else None
        if points:
            from ..util import fs
            from .killsweep import ensure_points_registered

            ensure_points_registered()
            unknown = [
                p for p in points if p not in fs.registered_kill_points()
            ]
            if unknown:
                print(
                    "unknown kill point(s): %s" % ",".join(unknown),
                    file=sys.stderr,
                )
                return 2
        report = run_kill_sweep(
            points=points,
            all_modes=args.modes == "all",
            target=args.target or DEFAULT_TARGET,
            keep=args.keep,
            log=lambda s: None if args.as_json else print(s),
            signature_backend=args.signature_backend,
        )
        if args.as_json:
            print(json.dumps(report, sort_keys=True))
        else:
            if report.get("error"):
                print("kill-sweep ERROR: %s" % report["error"])
            print(
                "kill-sweep: %d/%d point×mode legs recovered bit-exact"
                " (%d distinct points killed; window crosses %d of %d"
                " registered)"
                % (
                    report.get("recovered", 0),
                    report.get("swept", 0),
                    len(report.get("points_swept", [])),
                    len(report.get("points_hit", [])),
                    report.get("points_registered", 0),
                )
            )
        return 0 if report.get("ok") else 1

    only = args.only.split(",") if args.only else None
    if only:
        unknown = [c for c in only if c not in FAULT_CLASSES]
        if unknown:
            print("unknown fault class(es): %s" % ",".join(unknown),
                  file=sys.stderr)
            return 2

    try:
        results = run_matrix(matrix=args.matrix, only=only, seed=args.seed,
                             signature_backend=args.signature_backend)
    except ValueError as e:
        # run_matrix raises for classes absent from the chosen matrix
        # (big-only shapes like tcp_scale) — a silently-empty run must
        # not read as a green matrix
        print(str(e), file=sys.stderr)
        return 2
    any_fail = False
    for r in results:
        if args.as_json:
            print(json.dumps(r.to_dict(), sort_keys=True))
        else:
            sb = r.scoreboard
            print(
                "%-24s %-4s ledgers=%d (%.2f/s) nom=%d ballot=%d "
                "rejects=%d slip=%d recovery=%s inv=%d digest=%s"
                % (
                    r.name,
                    "ok" if r.ok else "FAIL",
                    sb.ledgers_closed,
                    sb.ledgers_per_sec,
                    sb.nomination_rounds,
                    sb.ballot_rounds,
                    sb.fast_rejects,
                    sb.slip_rejects_past + sb.slip_rejects_future,
                    ("%.0fms" % sb.recovery_ms)
                    if sb.recovery_ms is not None
                    else "-",
                    sb.invariant_violations,
                    sb.digest(),
                )
            )
            for f in r.failures:
                print("    FAIL: %s" % f)
        any_fail = any_fail or not r.ok
    return 1 if any_fail else 0


if __name__ == "__main__":
    sys.exit(main())
