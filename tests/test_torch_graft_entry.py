"""The port's driver entry points (stellar_tpu_torch/graft_entry.py) against
the root __graft_entry__.py, on this CPU host.

- ``_mixed_lane_items(n)``: the same (pk, msg, sig) triples byte for byte
  and the same mask, signed with libsodium and, as on the card's machine
  (no libsodium), with ref25519 over the harness's spawn pool, where the
  oracle is ref25519's verify: exact against libsodium's mask;
- ``filter_xla_noise``: equal to the JAX one on spam, feature soups, a
  20-comma error line and the cap;
- ``_example_args(16)``: the four arrays element for element (int32) and
  the mask;
- ``entry(device="cpu")``: the plain ``verify_kernel``'s verdicts equal
  ``jax.jit(verify_kernel)`` on the JAX arrays (N = 16, one compiled
  shape) and the mask; the card step's packing (``_pack``) through the
  plain packed version gives the same verdicts;
- ``dryrun_multichip(2, device="cpu")`` on the ``[cpu] * 2`` rig: exact
  against the mask, the JAX OK line;
- the CLI: the verdicts printed with ``PROFILE_DEVICE=cpu``; without CUDA
  and without it, rc 2 and a line naming CUDA.

Tolerance: exact everywhere.  JAX is imported inside fixtures only: the
``cuda`` case runs on a card's machine, which has no JAX.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stellar_tpu_torch import graft_entry as tge  # noqa: E402
from stellar_tpu_torch import harness  # noqa: E402
from stellar_tpu_torch.crypto import sodium  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jge(monkeypatch):
    """The JAX package's __graft_entry__."""
    pytest.importorskip("jax")
    monkeypatch.syspath_prepend(REPO)
    return importlib.import_module("__graft_entry__")


@pytest.mark.parametrize("n", [16, 13])
def test_mixed_lane_items_equal_jax(jge, n):
    items, want = tge._mixed_lane_items(n)
    j_items, j_want = jge._mixed_lane_items(n)
    assert items == j_items
    assert want.dtype == bool and (want == j_want).all()


def test_pool_signed_lanes_and_ref25519_oracle_equal_libsodium(jge, monkeypatch):
    """Where libsodium does not load: lanes signed over the spawn pool, the
    mask from ref25519's verify — both equal the libsodium-built ones."""
    j_items, j_want = jge._mixed_lane_items(16)
    monkeypatch.setattr(sodium, "available", lambda: False)
    monkeypatch.setattr(harness, "_pool", harness.signing_pool(2))
    try:
        items, want = tge._mixed_lane_items(16)
        assert harness.oracle_name() == "ref25519"
    finally:
        harness.close_pool()
    assert items == j_items
    assert (want == j_want).all()


@pytest.mark.parametrize("text, cap", [
    ("I0101 cpu_aot_loader.cc:1] Machine type used for XLA:CPU compilation\n"
     "+avx,+avx2,+fma,-amx-fp16,+sse4.2,+bmi,+bmi2,+lzcnt,+movbe,+popcnt,+f16c,+xsave,"
     "+adx,+aes,+pclmul,+rdrnd,+rdseed,+sha,+sse3,+ssse3,+cx16\n"
     "MESH_LEG {\"n_devices\": 2}\nverdict ok\n", 2000),
    ("Traceback (most recent call last):\nValueError: a, b, c, d, e, f, g, h, i, j, k, "
     "l, m, n, o, p, q, r, s, t, u, v\nThis could lead to execution errors\n", 2000),
    ("\n".join(f"line {i}: verdict" for i in range(200)), 120),
    ("", 2000),
    ("An NVIDIA GPU may be present on this machine\n", 2000),
])
def test_filter_xla_noise_equals_jax(jge, text, cap):
    assert tge.filter_xla_noise(text, cap=cap) == jge.filter_xla_noise(text, cap=cap)


def test_example_args_equal_jax(jge):
    args, want = tge._example_args(16, "cpu")
    j_args, j_want = jge._example_args(16)
    assert (want == j_want).all()
    assert [tuple(a.shape) for a in args] == [(32, 16), (32, 16), (64, 16), (64, 16)]
    for a, ja in zip(args, j_args):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        assert (a.numpy() == np.asarray(ja)).all()


def test_entry_cpu_equals_jax_verify_kernel_and_mask(jge):
    import jax

    j_fn, j_args = jge.entry()
    j_got = np.asarray(jax.jit(j_fn)(*j_args))
    fn, args = tge.entry(device="cpu")
    assert fn is ted.verify_kernel
    got = fn(*args).numpy()
    _, want = tge._example_args(16, "cpu")
    assert (got == j_got).all() and (got == want).all()
    # the card step's packing, through the plain packed version
    packed = tge._pack(*args)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (128, 16)
    assert (ted._verify_packed(packed, signed=False).numpy() == want).all()


def test_dryrun_multichip_on_the_cpu_rig(capsys):
    tge.dryrun_multichip(2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dryrun_multichip mesh: [cpu, cpu] (repeated-device rig)"
    assert lines[-1] == ("dryrun_multichip OK: 256 lanes over 2 devices, 64 valid / "
                         f"192 rejected, mask exact vs {harness.oracle_name()}")


def _cli(args, env_extra=None, drop=("PROFILE_DEVICE",)):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {}, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "stellar_tpu_torch.graft_entry", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def test_cli_prints_the_verdicts_on_the_cpu():
    r = _cli([], {"PROFILE_DEVICE": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    _, want = tge._mixed_lane_items(16)
    assert r.stdout.strip() == str(want)


@pytest.mark.parametrize("args", [[], ["multichip", "2"]])
def test_no_cuda_cli_exits_2_naming_cuda(args):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = _cli(args)
    assert r.returncode == 2
    assert "CUDA" in r.stderr and r.stdout == ""


@pytest.mark.cuda
def test_entry_and_dryrun_on_card(capsys):
    """On the card: the step launches B1 (never the plain version) and its
    verdicts equal the mask; the dryrun over two shards on the card(s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    try:
        fn, args = tge.entry()
        assert all(a.is_cuda for a in args)
        _, want = tge._mixed_lane_items(16)
        before, plain = ec.launches, ted.plain_calls
        got = fn(*args).cpu().numpy()
        assert (got == want).all()
        assert ec.launches == before + 1 and ted.plain_calls == plain
        tge.dryrun_multichip(2)
    finally:
        harness.close_pool()
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "dryrun_multichip OK: 256 lanes over 2 devices, 64 valid / 192 rejected")
