"""One run of one cell of the port's benchmark.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix,
its entry and its metrics are found by name (``port_bench/cells.py``).  A
run:

1. makes the mix's inputs from ``--seed`` (``port_bench/generator.py``),
   builds the system under test from the configuration's knobs, under the
   configuration's ``environment``, and warms up every call shape: the
   set-up, ``setup_s``, counted from the start of the process;
2. drives the entry in a closed loop, one caller, for ``--seconds``: every
   call's wall time and verdict count are kept, and the verdict lists of a
   seeded sample of calls (every ``keep_every``-th);
3. with ``--trace 0`` reports the cell's end-to-end metrics; with
   ``--trace 1`` also passes the program a span tracer, runs
   ``torch.profiler`` over the window (``port_bench/devtrace.py``) and
   reports the cell's per-layer metrics and a breakdown.  Only the metrics
   that ``BENCHMARK.json`` lists for the cell are read: the other mode's go
   under ``readings``, with no bound;
4. after the window, frees the program and judges every triple of the pool
   with the frozen reference (``port_bench/reference/ed25519.py``), then
   compares every verdict of the sampled calls with it: ``correct`` holds
   when none differs and no verdict is missing.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the last key of
that object.  Without CUDA, or with fewer cards than the cell asks for, or
where the program is not the checkout's, or where ``jax``, ``jaxlib``,
``flax`` or ``stellar_tpu`` was loaded, the run prints no result and exits
with a code other than 0.
"""

import time

_T0 = time.monotonic()  # set-up is counted from the start of the process

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "stellar_tpu")
PROGRAM = "stellar_tpu_torch"
# the program's counters reported over the window (its stats())
COUNTERS = ("device_calls", "items", "gate_rejects", "stalled_items")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Kernel and build caches of the libraries the program may use, at fixed
    paths inside the checkout (the program's own nvcc builds are under
    ``stellar_tpu_torch/_build/``)."""
    base = os.path.join(root, "port_bench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)


def _window(call, calls, seconds: float, keep_every: int, keep_offset: int) -> dict:
    """The closed loop: one caller, the call orders in turn, until
    ``seconds`` have passed at the end of a call."""
    times, kept, errors = [], {}, []
    verdicts = attempted = failed = 0
    c = 0
    t0 = time.monotonic()
    while True:
        items = calls[c % len(calls)]
        a = time.monotonic()
        try:
            res = call(items)
        except Exception as e:  # counted as failed; the run goes on
            res = None
            errors.append(repr(e))
        b = time.monotonic()
        times.append((a, b))
        attempted += len(items)
        if res is None or len(res) != len(items):
            failed += len(items)
        else:
            verdicts += len(res)
        if c % keep_every == keep_offset:
            kept[c] = res
        c += 1
        if b - t0 >= seconds:
            break
    return {"t0": t0, "t1": b, "times": times, "kept": kept, "errors": errors,
            "verdicts": verdicts, "attempted": attempted, "failed": failed}


def _nvidia_smi() -> str:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else "unavailable"


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, build=None):
    """Set-up, window and comparison of one run -> (result, stderr lines).

    ``device`` "cpu" runs the kernels' plain versions (the tests only);
    ``build`` replaces the cell's entry (the control, the tests' faults)."""
    import numpy as np
    import torch

    from port_bench import cells, devtrace, generator, roofline
    from port_bench.reference import ed25519 as ref

    t0 = _T0 if t0 is None else t0
    cell = cells.find(root, workload)
    cfg, mix = cell.config, cell.mix
    cuda = torch.device(device).type == "cuda"
    phases = {"imports": time.monotonic() - t0}
    traffic = generator.build(mix, seed)
    phases["traffic"] = time.monotonic() - t0 - sum(phases.values())
    # the program settings that the configuration states and no Config knob
    # holds; read when the system under test is built
    env = {k: str(v) for k, v in cfg.get("environment", {}).items()}
    gate = np.array([ref.gate(pk, sig) for pk, _, sig in traffic.pool])
    one_block = gate & np.array([len(m) <= roofline.ONE_BLOCK_MSG for _, m, _ in traffic.pool])
    tracer = None
    if trace:
        from stellar_tpu_torch.trace import Tracer

        tracer = Tracer(enabled=True, ring_size=1 << 18)
    build = build or cells.entry(root, cfg["entry"])
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sut = build(cfg["knobs"], cfg["caller"], device, tracer)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    phases["build"] = time.monotonic() - t0 - sum(phases.values())
    for w in range(int(mix.get("warmup_calls", 1))):
        sut.call(traffic.calls[w % len(traffic.calls)])
    if cuda:
        torch.cuda.synchronize()
    if tracer is not None:
        tracer.clear()
    stats0 = sut.stats()
    setup_s = time.monotonic() - t0
    phases["warmup"] = setup_s - sum(phases.values())

    keep_every = int(mix.get("keep_every", 1))
    keep_offset = int.from_bytes(generator.master(seed)[16:20], "little") % keep_every
    prof = devtrace.Profiled() if cuda and trace else None
    cpu0 = os.times()
    if prof is not None:
        with prof:
            win = _window(sut.call, traffic.calls, seconds, keep_every, keep_offset)
    else:
        win = _window(sut.call, traffic.calls, seconds, keep_every, keep_offset)
    cpu1 = os.times()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats1 = sut.stats()
    spans = [(s.name, s.start, s.end) for s in tracer.spans()] if tracer is not None else []
    sut.close()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the program is gone
    tr = time.monotonic()
    want = np.array(generator.over_pool(ref.verify_many, traffic.pool), dtype=bool)
    ref_s = time.monotonic() - tr
    expect = np.array([c == generator.GOOD for c in traffic.classes])
    if not np.array_equal(want, expect):
        raise RuntimeError(
            f"the traffic is not what it claims: the reference accepts {int(want.sum())}"
            f" of {len(want)} triples, {int(expect.sum())} of them signed as good"
        )
    mismatches = compared = 0
    for c, res in win["kept"].items():
        order = traffic.orders[c % len(traffic.orders)]
        if res is None or len(res) != len(order):
            continue  # counted as missing
        got = np.fromiter(res, dtype=bool, count=len(res))
        mismatches += int(np.count_nonzero(got != want[order]))
        compared += len(res)

    n_calls = len(win["times"])
    per_order_gate = [int(gate[o].sum()) for o in traffic.orders]
    per_order_one = [int(one_block[o].sum()) for o in traffic.orders]
    ctx = SimpleNamespace(
        verdicts=win["verdicts"], window_s=win["t1"] - win["t0"], setup_s=setup_s,
        call_ms=[1e3 * (b - a) for a, b in win["times"]],
        spans=spans + [("port_bench.call", a, b) for a, b in win["times"]],
        device=prof.trace if prof is not None else None,
        lanes={
            "gate_ok": sum(per_order_gate[c % len(per_order_gate)] for c in range(n_calls)),
            "one_block": sum(per_order_one[c % len(per_order_one)] for c in range(n_calls)),
        },
        counters={k: stats1[k] - stats0[k] for k in COUNTERS if k in stats0 and k in stats1},
        config=cfg,
    )
    metrics, readings = {}, {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the cell's metrics of the other mode, with no bound, where this run
    # has something for them to read
    for m in (cell.end_to_end if trace else cell.per_layer):
        v = cells.reader(root, m["name"])(ctx)
        if v is not None:
            readings[m["name"]] = v
    checks = {"mismatches": {"value": mismatches, "limit": 0},
              "missing": {"value": win["failed"], "limit": 0}}
    correct = (all(v["value"] <= v["limit"] for v in checks.values())
               and compared > 0 and not win["errors"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    lines = [
        f"# {workload} seed {seed}: setup {setup_s:.3f} s, window {ctx.window_s:.3f} s,"
        f" {n_calls} calls, {win['verdicts']} verdicts, reference {ref_s:.2f} s",
        "# set-up phases, s: " + json.dumps(phases),
        "# call ms p5/p50/p95/max: " + " ".join(
            f"{v:.3f}" for v in np.percentile(ctx.call_ms, [5, 50, 95, 100]))
        + f"; process CPU s over the window: user {cpu1.user - cpu0.user:.2f}"
        f" system {cpu1.system - cpu0.system:.2f}",
        "# program counters over the window: " + json.dumps(ctx.counters),
    ]
    for e in win["errors"][:5]:
        lines.append(f"# error in the window: {e}")
    lines.append(f"# the cell's metrics of the other mode: {json.dumps(readings)}")
    if prof is not None:
        dev["busy_s"] = prof.trace.busy_s
        dev["window_s"] = prof.trace.window_s
        index = devtrace.SpanIndex(ctx.spans)
        result["breakdown"] = devtrace.breakdown(prof.trace, index)
        idle = devtrace.idle_by_span(prof.trace, index)
        result["idle_by_span"] = idle
        lines.append(f"# idle seconds by the host spans open: {json.dumps(idle)}")
    if cuda:
        result["nvidia_smi"] = _nvidia_smi()
        lines.append(f"# card: {result['nvidia_smi']}")
    result.update(workload=workload, seed=seed, calls=n_calls, compared=compared,
                  reference_s=ref_s, readings=readings)
    result["checks"] = checks
    lines += [f"{k} {v['value']} limit {v['limit']}" for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(os.getcwd())
    from port_bench import cells

    cell = cells.find(root, args.workload)
    set_cache_dirs(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import stellar_tpu_torch
    except ImportError as e:
        print(f"the program under test does not import: {e}", file=sys.stderr)
        return 5
    home = os.path.dirname(os.path.dirname(os.path.abspath(stellar_tpu_torch.__file__)))
    if home != root:
        print(f"{PROGRAM} comes from {home}, not from this checkout ({root})", file=sys.stderr)
        return 5
    result, lines = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules that the port's runs may not load were loaded: {bad}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
