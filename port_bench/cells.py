"""Cell discovery: everything of a cell is found by name from
``BENCHMARK.json`` at the root of the checkout.

- a configuration is the file its ``configs`` entry names
  (``port_bench/configs/<config>.json``): the program's knobs, the entry that
  the window drives and the caller class, the guarantees, the reference;
- a traffic mix is ``port_bench/traffic/<traffic>.json``, parameters that the
  one generator (``port_bench/generator.py``) reads;
- an entry is ``port_bench/entries/<entry>.py``, with ``build(knobs, caller,
  device, tracer)``;
- a metric, end-to-end or per-layer, is ``port_bench/metrics/<name>.py``,
  with ``read(ctx)`` returning a number, or None where it finds nothing; a
  run reads only the metrics that ``BENCHMARK.json`` lists for its cell.

A later cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import List, NamedTuple

BENCH_DIR = "port_bench"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration's file, with its BENCHMARK.json name
    mix: dict           # the traffic mix's parameters
    end_to_end: List[dict]
    per_layer: List[dict]


def benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, moved=None) -> bool:
    """A metric with a ``workloads`` key is the listed cells'; an end-to-end
    metric without one is every cell's, a per-layer one every cell's that
    reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moved is None or metric["moves"] in moved


def find(root: str, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``."""
    bench = benchmark(root)
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = work[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    config = {**_json(os.path.join(root, conf["file"])), "name": conf["name"]}
    mix = _json(os.path.join(root, BENCH_DIR, "traffic", work["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, moved)]
    return Cell(name, int(work["chips"]), config, mix, e2e, layer)


def _module(path: str):
    mod_name = "port_bench_" + re.sub(r"\W", "_", os.path.relpath(path))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, metric: str):
    """The ``read`` function of a metric."""
    return _module(os.path.join(root, BENCH_DIR, "metrics", metric + ".py")).read


def entry(root: str, name: str):
    """The ``build`` function of an entry."""
    return _module(os.path.join(root, BENCH_DIR, "entries", name + ".py")).build
