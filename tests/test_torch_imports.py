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
            "stellar_tpu_torch.bucket.hashplane"} <= set(names)
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
) + [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_ab.py")])
def test_sources_name_no_jax_or_jax_package_import(path):
    src = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    for m in re.finditer(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M):
        mod = m.group(1)
        assert not (mod == "stellar_tpu" or mod.startswith("stellar_tpu.")), (path, mod)
