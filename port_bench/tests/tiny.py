"""A copy of the benchmark at a size the CPU runs in seconds: the real
configurations and mix with 32-lane chunks, 48-item calls and a pool of 24
triples (one of each bad class), in a temporary checkout root.  Its
BENCHMARK.json also holds the host-hash cell, added as a later change would
add it: a configuration file and an entry, and nothing else."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = ("sig32k-devhash.payments",)
HOSTHASH = "sig32k-hosthash.payments"


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def make_root(tmp: Path, **mix) -> Path:
    """A checkout root under ``tmp`` with BENCHMARK.json and port_bench/ cut
    to the tiny size; ``mix`` overrides the traffic's parameters."""
    root = tmp / "root"
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")

    def add_hosthash(b):
        b["configs"].append({"name": "sig32k-hosthash", "source": "https://example.org",
                             "file": "port_bench/configs/sig32k-hosthash.json", "reduced": [],
                             "why": "the host hashes"})
        b["workloads"].append({"name": HOSTHASH, "config": "sig32k-hosthash",
                               "traffic": "payments", "chips": 1, "why": "the host hashes"})
        for m in b["per_layer"]:
            if m["name"] != "sha512_h_roofline":
                m["workloads"].append(HOSTHASH)

    _edit(root / "BENCHMARK.json", add_hosthash)
    conf = json.loads((root / "port_bench" / "configs" / "sig32k-devhash.json").read_text())
    conf["knobs"]["DEVICE_HASH"] = False
    (root / "port_bench" / "configs" / "sig32k-hosthash.json").write_text(json.dumps(conf))
    for conf in (root / "port_bench" / "configs").glob("*.json"):
        _edit(conf, lambda d: d["knobs"].update(SIG_BATCH_MAX=32))
    _edit(root / "port_bench" / "traffic" / "payments.json",
          lambda d: d.update(dict(pool=24, call_items=48, bad_share=0.125, orders=2,
                                  warmup_calls=1, keep_every=1), **mix))
    return root
