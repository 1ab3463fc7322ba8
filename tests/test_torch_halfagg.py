"""The port's aggregate-signature plane (stellar_tpu_torch/crypto/aggregate)
against the JAX package's, on this CPU host: a twin of
tests/test_halfagg.py::test_flush_verdicts_bit_identical.

Every hostile lane of that test (bad signatures, s >= L, small-order and
non-canonical points, off-curve points, a wrong message, mixed-torsion A,
a torsioned nonce) is flushed through both packages' SCP signature schemes
under both SCP_SIG_SCHEME values.  The port runs two backends: the cpu
backend (libsodium) and the gpu backend below its cutover, whose verifies
and fresh-R torsion proofs take the host path (libsodium and the
``native/halfagg.c`` ladder) — the path a stalled or latched device batch
takes too.  Tolerance: exact — every verdict equal to the JAX scheme's and
to one libsodium verify per envelope, and no invalid verdict latched.
"""

import pytest

pytest.importorskip("torch")

import test_halfagg as jtest  # noqa: E402
from stellar_tpu.crypto.aggregate import make_scheme as jax_make_scheme  # noqa: E402
from stellar_tpu.crypto.sigbackend import CachingSigBackend as JaxCaching  # noqa: E402
from stellar_tpu.crypto.sigbackend import CpuSigBackend as JaxCpu  # noqa: E402
from stellar_tpu.crypto.sigcache import VerifySigCache as JaxCache  # noqa: E402
from stellar_tpu_torch.crypto import sodium  # noqa: E402
from stellar_tpu_torch.crypto.aggregate import make_scheme  # noqa: E402
from stellar_tpu_torch.crypto.sigbackend import (  # noqa: E402
    CachingSigBackend,
    CpuSigBackend,
    GpuSigBackend,
)
from stellar_tpu_torch.crypto.sigcache import VerifySigCache  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

pytestmark = pytest.mark.skipif(not sodium.available(), reason="libsodium not found")

BACKENDS = {
    "cpu": CpuSigBackend,
    "gpu_below_cutover": lambda: GpuSigBackend(device="cpu", cpu_cutover=1 << 20),
}


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("scheme_name", ["ed25519", "ed25519-halfagg"])
@pytest.mark.parametrize("lane", jtest.LANES, ids=[f.__name__ for f in jtest.LANES])
def test_flush_verdicts_bit_identical(scheme_name, lane, backend):
    items = lane(jtest.make_items(12))
    want = jtest.oracle(items)
    jcache = JaxCache()
    jscheme = jax_make_scheme(scheme_name, JaxCaching(JaxCpu(), jcache), jcache)
    assert jscheme.verify_flush(items, [7] * len(items)) == want
    inner = BACKENDS[backend]()
    cache = VerifySigCache()
    scheme = make_scheme(scheme_name, CachingSigBackend(inner, cache), cache)
    verdicts = scheme.verify_flush(items, [7] * len(items))
    assert verdicts == want
    keys = [cache.key_for(pk, sig, msg) for pk, msg, sig in items]
    for v, ok in zip(cache.peek_many(keys), verdicts):
        assert v in (None, True)
        if v is not None:
            assert ok  # only VALID verdicts may latch
    # the warm-cache re-flush returns the same verdicts
    assert scheme.verify_flush(items, [7] * len(items)) == verdicts
    if backend != "cpu":
        st = inner.stats()
        assert st["device_calls"] == 0 and st["device_dispatches"] == {}
        assert st["cpu_cutover_items"] + st["cpu_cutover_torsion"] > 0
        if scheme_name == "ed25519-halfagg" and lane is jtest._lane_honest:
            assert st["cpu_cutover_torsion"] == len(items)  # the fresh-R proofs
