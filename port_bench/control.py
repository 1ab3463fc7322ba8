"""The control of the comparison that decides ``correct``, and the program's
readings beside it, on several seeds in one process.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 --seconds 3 [--side control|program|both]

``control``: the frozen reference's lax verifier (``verify_lax``: the
cofactorless equation without libsodium's strict rules, the one guarantee
the configurations state that a faster verifier is tempted to drop) is put
in the program's place, and a run of the cell is made with it: its window,
its sample of calls and its comparison, at the cell's own call size.  It
has to come out not correct.  ``program``: the same with the cell's own
entry, the readings that the limit sits above.  One JSON line a run.

The lax verdicts of the pool are worked out once, on the warm-up call, over
the generator's process pool; the window then answers each triple from
them, as a verifier put in the program's place would.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import generator, run
from port_bench.reference import ed25519 as ref


class Lax:
    """A system under test that answers every triple with ``verify_lax``."""

    def __init__(self, *args, **kw):
        self._verdicts = {}

    def call(self, items):
        todo = [t for t in dict.fromkeys(items) if t not in self._verdicts]
        if todo:
            self._verdicts.update(zip(todo, generator.over_pool(ref.verify_lax_many, todo)))
        return [self._verdicts[t] for t in items]

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        self._verdicts = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--side", choices=("control", "program", "both"), default="both")
    args = ap.parse_args(argv)
    root = os.path.abspath(os.getcwd())
    run.set_cache_dirs(root)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    sides = ("program", "control") if args.side == "both" else (args.side,)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            t0 = time.monotonic()
            res, lines = run.run_cell(root, args.workload, seed, args.seconds, False,
                                      device=device, t0=t0,
                                      build=Lax if side == "control" else None)
            print("\n".join(lines), file=sys.stderr)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "side": side, "correct": res["correct"],
                "mismatches": res["checks"]["mismatches"]["value"],
                "missing": res["checks"]["missing"]["value"], "compared": res["compared"],
                "calls": res["calls"], "device": res["device"]["kind"],
                "seconds": time.monotonic() - t0,
            }), flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"modules that the port's runs may not load were loaded: {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
