"""The port's fuzzer (stellar_tpu_torch/main/fuzz.py) and its CLI modes
against the JAX package's, on this CPU host: twins of
tests/test_fuzz_cli.py's genfuzz, replay and garbage-input tests on a tiny
corpus.

``fuzz()`` builds its node pair from ``get_test_config(90/91)``, which in
the port means the gpu backend on ``cuda``; the tests patch the port's
``tx.testutils.get_test_config`` to ``SIG_DEVICE = "cpu"``, so the pair's
batch verifies run the verify kernel's plain version.  Tolerance: exact —
the same corpus bytes for the same seed, and the same exit codes.
"""

import struct

import pytest

pytest.importorskip("torch")

from stellar_tpu.main import fuzz as jfuzz  # noqa: E402
from stellar_tpu.tx import testutils as jtestutils  # noqa: E402
from stellar_tpu_torch.main import cli  # noqa: E402
from stellar_tpu_torch.main import fuzz as tfuzz  # noqa: E402
from stellar_tpu_torch.tx import testutils  # noqa: E402
from stellar_tpu_torch.util.xdrstream import XDRInputFileStream  # noqa: E402
from stellar_tpu_torch.xdr.overlay import StellarMessage  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)


@pytest.fixture
def plain_device(monkeypatch, tmp_path):
    """The fuzzer's node pair on the plain versions (SIG_DEVICE = "cpu").
    The JAX package's pair gets its directories under tmp_path: its test
    configs share /tmp/stellar-tpu-test-* paths by instance number with
    tests/test_fuzz_cli.py, which may run at the same time in another
    worker."""
    real = testutils.get_test_config

    def on_cpu(instance=0, backend="gpu"):
        cfg = real(instance, backend=backend)
        cfg.SIG_DEVICE = "cpu"
        return cfg

    jreal = jtestutils.get_test_config

    def own_dirs(instance=0, *a, **kw):
        cfg = jreal(instance, *a, **kw)
        cfg.BUCKET_DIR_PATH = str(tmp_path / f"jax-buckets-{instance}")
        cfg.TMP_DIR_PATH = str(tmp_path / f"jax-tmp-{instance}")
        return cfg

    monkeypatch.setattr(testutils, "get_test_config", on_cpu)
    monkeypatch.setattr(jtestutils, "get_test_config", own_dirs)


@pytest.mark.parametrize("n,seed", [(5, 7), (3, 11), (2, 3)])
def test_genfuzz_matches_jax(tmp_path, n, seed):
    port, jax = str(tmp_path / "port.xdr"), str(tmp_path / "jax.xdr")
    tfuzz.gen_fuzz(port, n=n, seed=seed)
    jfuzz.gen_fuzz(jax, n=n, seed=seed)
    assert open(port, "rb").read() == open(jax, "rb").read()
    with XDRInputFileStream(port) as f:
        assert len(list(f.read_all(StellarMessage))) == n


def test_fuzz_replay_runs_to_completion(tmp_path, plain_device):
    path = str(tmp_path / "fuzz-in.xdr")
    tfuzz.gen_fuzz(path, n=3, seed=11)
    assert tfuzz.fuzz(path) == jfuzz.fuzz(path) == 0


def test_fuzz_survives_garbage_input(tmp_path, plain_device):
    """Truncated/garbage records must substitute a stand-in, not crash."""
    path = str(tmp_path / "garbage.xdr")
    with open(path, "wb") as f:
        body = b"\xde\xad\xbe\xef" * 5
        f.write(struct.pack(">I", len(body) | 0x80000000) + body)
    assert tfuzz.fuzz(path) == jfuzz.fuzz(path) == 0


def test_cli_genfuzz_then_fuzz(tmp_path, plain_device, capsys):
    """The port's CLI runs both fuzzer modes (they used to refuse)."""
    path = str(tmp_path / "cli.xdr")
    assert cli.main(["--genfuzz", path]) == 0
    with XDRInputFileStream(path) as f:
        assert len(list(f.read_all(StellarMessage))) > 0
    assert cli.main(["--fuzz", path]) == 0
