"""Import hygiene of the port: stellar_tpu_torch imports torch, never jax,
and nothing of the JAX package (importing any stellar_tpu.ops module runs
its jax setup); it keeps its own copies of what it needs."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "stellar_tpu_torch")


def _modules():
    import stellar_tpu_torch

    names = ["stellar_tpu_torch"]
    for info in pkgutil.walk_packages(stellar_tpu_torch.__path__, "stellar_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_the_jax_package():
    names = _modules()
    assert {"stellar_tpu_torch.ops.ed25519", "stellar_tpu_torch.crypto.sigbackend",
            "stellar_tpu_torch.ops.ed25519_cuda", "stellar_tpu_torch.native",
            "stellar_tpu_torch.ops.sha512", "stellar_tpu_torch.ops.sha512_cuda",
            "stellar_tpu_torch.ops.sha256", "stellar_tpu_torch.ops.sha256_cuda",
            "stellar_tpu_torch.bucket.hashplane", "stellar_tpu_torch.main.fuzz",
            "stellar_tpu_torch.analysis", "stellar_tpu_torch.analysis.__main__",
            "stellar_tpu_torch.analysis.core", "stellar_tpu_torch.analysis.crules",
            "stellar_tpu_torch.analysis.registry", "stellar_tpu_torch.analysis.report",
            "stellar_tpu_torch.analysis.rules", "stellar_tpu_torch.scenarios",
            "stellar_tpu_torch.scenarios.__main__", "stellar_tpu_torch.scenarios.faults",
            "stellar_tpu_torch.scenarios.killsweep", "stellar_tpu_torch.scenarios.matrix",
            "stellar_tpu_torch.scenarios.scenario", "stellar_tpu_torch.scenarios.scoreboard",
            "stellar_tpu_torch.scenarios.storagefaults",
            "stellar_tpu_torch.parallel", "stellar_tpu_torch.parallel.mesh",
            "stellar_tpu_torch.bench", "stellar_tpu_torch.profile_close",
            "stellar_tpu_torch.profile_system", "stellar_tpu_torch.profile_kernel",
            "stellar_tpu_torch.graft_entry", "stellar_tpu_torch.harness"} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'stellar_tpu' or m.startswith('stellar_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f)
    for d, _, fs in os.walk(PKG)
    for f in fs
    if f.endswith(".py")
) + [os.path.join(REPO, f) for f in ("chip_smoke.py", "kernel_ab.py", "path_ab.py")])
def test_sources_name_no_jax_or_jax_package_import(path):
    src = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    for m in re.finditer(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M):
        mod = m.group(1)
        assert not (mod == "stellar_tpu" or mod.startswith("stellar_tpu.")), (path, mod)
        # nor the JAX package's root entry points (bench.py, profile_*.py,
        # __graft_entry__.py)
        assert mod not in ("bench", "profile_close", "profile_system", "profile_kernel",
                           "__graft_entry__"), (path, mod)
