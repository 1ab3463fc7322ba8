"""The hand-written Hopper verify kernel (stellar_tpu_torch/csrc/
ed25519_verify.cu) and its wrapper (ops/ed25519_cuda.py).

CUDA has no interpret mode, so on a host without a card the kernel's
arithmetic is still held against its plain PyTorch version by compiling the
same source as host C++ (the CUDA qualifiers defined away, one lane per
call) and running it on the lane mix chip_smoke.py uses on the card.  The
run on the card itself is the ``cuda`` test below, which skips without
CUDA.  Tolerance: exact (boolean verdicts).
"""

import ctypes
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from stellar_tpu_torch.crypto import SecretKey  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ed  # noqa: E402
from stellar_tpu_torch.ops import ed25519_cuda as ec  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as ref  # noqa: E402
from torch_host_cuda import build_host_kernel  # noqa: E402

_HOST_LOOP = r"""
extern "C" void host_verify(const uint8_t *p, uint8_t *out, int n,
                            const int32_t *consts) {
    for (int i = 0; i < n; i++) {
        blockIdx.x = i;
        ed25519_verify_kernel(p, out, n, consts);
    }
}
"""


def _lanes(n, seed):
    rng = random.Random(seed)
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(1000 + i)
        msg = rng.getrandbits(256).to_bytes(32, "little")
        items.append((sk.public_raw, msg, sk.sign(msg)))
    return chip_smoke.kernel_lanes(rng, items, n)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    lib = build_host_kernel(ec.SOURCE, _HOST_LOOP, tmp_path_factory.mktemp("kernel_host"))
    lib.host_verify.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.host_verify.restype = None
    return lib


def test_kernel_source_matches_plain_version(host_kernel):
    packed = _lanes(64, seed=8)
    consts = ec.kernel_constants()
    out = np.zeros(packed.shape[1], dtype=np.uint8)
    host_kernel.host_verify(packed.ctypes.data, out.ctypes.data, packed.shape[1], consts.ctypes.data)
    plain = ed._verify_packed(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(out.astype(bool), plain)
    assert plain.any() and not plain.all()
    assert plain[5::8].all()  # s >= L on a valid signature verifies (mod L)


def test_kernel_constants_encode_the_shared_tables():
    c = ec.kernel_constants().astype(np.int64)

    def val(limbs):
        v, off = 0, 0
        for i, l in enumerate(limbs):
            v += int(l) << off
            off += 25 if i & 1 else 26
        return v

    tab = c[: 16 * 4 * 10].reshape(16, 4, 10)
    for k, (ypx, ymx, t2d) in enumerate(ed.base_niels_affine()):
        assert [val(tab[k, j]) for j in range(4)] == [ypx, ymx, t2d, 2]
    tail = c[16 * 4 * 10 :].reshape(3, 10)
    assert [val(t) for t in tail] == [ref.D, ed.D2, ref.SQRT_M1]
    # the niels table is the plain version's fixed-base table, re-encoded
    tab13 = ed._base_niels_table_np()
    for k, (ypx, ymx, t2d) in enumerate(ed.base_niels_affine()):
        assert [ed.fe.limbs_to_int(tab13[j, k]) for j in range(3)] == [ypx, ymx, t2d]


def test_wrapper_routes_cpu_tensors_to_plain_version():
    packed = torch.from_numpy(_lanes(8, seed=2))
    launches, plain = ec.launches, ed.plain_calls
    got = ec.verify_packed(packed)
    assert ec.launches == launches and ed.plain_calls == plain + 1
    assert got.dtype == torch.bool and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), ed._verify_packed(packed).numpy())
    with pytest.raises(ValueError):
        ec.verify_packed(packed.to("meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    packed = torch.from_numpy(_lanes(512, seed=4)).cuda()
    launches = ec.launches
    got = ec.verify_packed(packed)
    torch.cuda.synchronize()
    assert ec.launches == launches + 1
    plain = ed._verify_packed(packed)
    assert torch.equal(got, plain)
    with pytest.raises(ValueError):
        ec.verify_packed(packed[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        ec.verify_packed(packed[:64].contiguous())  # not 128 rows


@pytest.mark.cuda
def test_batch_verifier_streams_on_card():
    """Two stager threads, each on its own CUDA stream, five chunks in
    flight through pinned staging buffers: verdicts by construction."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = random.Random(6)
    items, want = [], []
    for i in range(600):
        sk = SecretKey.pseudo_random_for_testing(i)
        msg = b"streams %d" % i
        sig = bytearray(sk.sign(msg))
        if i % 7 == 3:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        items.append((sk.public_raw, msg, bytes(sig)))
        want.append(i % 7 != 3)
    bv = ed.BatchVerifier(max_batch=128, streams=2)
    launches, plain = ec.launches, ed.plain_calls
    assert bv.verify(items) == want
    assert bv.verify(items) == want  # pooled buffers reused
    assert ec.launches == launches + 10 and ed.plain_calls == plain
    encs = [it[0] for it in items[:5]] + [ref.small_order_blacklist()[2], b"\x02" * 32]
    want_t = [True] * 5 + [
        ref.decompress(e) is not None and ref.is_torsion_free(ref.decompress(e))
        for e in encs[5:]
    ]
    assert bv.verify_torsion(encs) == want_t
