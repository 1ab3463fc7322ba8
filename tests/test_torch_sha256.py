"""The bucket-hash plane's SHA-256 kernel path in the port: the packer and
the plain version (stellar_tpu_torch/ops/sha256.py), the Hopper kernel
(csrc/sha256_frames.cu, wrapper ops/sha256_cuda.py), against the JAX
package's ops/sha256.py and hashlib on this CPU host.

The kernel source is compiled as host C++ (the CUDA qualifiers defined
away, one lane per call) and held against the plain version; the run on the
card is the ``cuda`` test, which skips without CUDA.  JAX is imported in a
fixture (the card's machine has none, and its ``cuda`` test runs without
it); its side is kept to one compiled shape.  Tolerance: exact — arrays and
digests equal byte for byte.
"""

import ctypes
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stellar_tpu_torch.ops import sha256 as tsha  # noqa: E402
from stellar_tpu_torch.ops import sha256_cuda  # noqa: E402
from torch_host_cuda import build_host_kernel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

BOUNDARY = (0, 55, 56, 63, 64, 65, 119, 120)
PINNED = 4  # max_blocks of the one JAX shape: (256, len(_messages()))


def _messages(seed=17):
    """The padding-boundary lengths, the empty string twice, and random
    lengths up to three blocks."""
    rng = np.random.default_rng(seed)
    lengths = list(BOUNDARY) + [0, 1, 200, 183] + [int(x) for x in rng.integers(0, 184, 20)]
    return [rng.bytes(n) for n in lengths]


@pytest.fixture(scope="module")
def jsha():
    """The JAX package's ops/sha256.py."""
    pytest.importorskip("jax")
    from stellar_tpu.ops import sha256

    return sha256


@pytest.mark.parametrize("max_blocks", [0, PINNED, 9])
def test_pack_frames_identical_to_jax(jsha, max_blocks):
    msgs = _messages()
    packed, counts = tsha.pack_frames(msgs, max_blocks)
    jpacked, jcounts = jsha.pack_frames(msgs, max_blocks)
    assert packed.dtype == jpacked.dtype == np.uint8 and packed.flags.c_contiguous
    assert counts.dtype == jcounts.dtype == np.int32
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(counts, jcounts)
    assert [tsha.blocks_for(len(m)) for m in msgs] == [jsha.blocks_for(len(m)) for m in msgs]


def test_pack_frames_edges(jsha):
    for got, want in zip(tsha.pack_frames([]), jsha.pack_frames([])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tsha.pack_frames([bytes(120)], max_blocks=2)  # needs 3 blocks
    # memoryview items pack like bytes (the frame walk hands out views)
    msgs = _messages()
    views = [memoryview(m) for m in msgs]
    np.testing.assert_array_equal(tsha.pack_frames(views)[0], tsha.pack_frames(msgs)[0])


def test_plain_rows_match_jax_and_hashlib(jsha):
    import jax.numpy as jnp

    msgs = _messages()
    packed, counts = tsha.pack_frames(msgs, PINNED)
    calls = tsha.plain_calls
    got = tsha.sha256_rows_from_packed(torch.from_numpy(packed), torch.from_numpy(counts))
    assert tsha.plain_calls == calls + 1
    assert got.dtype == torch.int32 and got.shape == (32, len(msgs))
    want = np.asarray(jsha._jit_rows_from_packed(jnp.asarray(packed), jnp.asarray(counts)))
    np.testing.assert_array_equal(got.numpy(), want)
    digests = [bytes(got[:, i].to(torch.uint8).numpy()) for i in range(len(msgs))]
    assert digests == [hashlib.sha256(m).digest() for m in msgs]
    assert tsha.sha256_batch(msgs) == digests and tsha.sha256_batch([]) == []


# -- the CUDA source, compiled as host C++ ----------------------------------

_HOST_LOOP = r"""
extern "C" void host_digest(const uint8_t *p, const int32_t *nb, uint8_t *out,
                            int n, int max_blocks) {
    for (int i = 0; i < n; i++) {
        blockIdx.x = i;
        sha256_frames_kernel(p, nb, out, n, max_blocks);
    }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    lib = build_host_kernel(sha256_cuda.SOURCE, _HOST_LOOP, tmp_path_factory.mktemp("sha256_host"))
    lib.host_digest.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.host_digest.restype = None
    return lib


def test_kernel_source_matches_plain_version(host_kernel):
    msgs = _messages(seed=18)
    packed, counts = tsha.pack_frames(msgs, 8)
    hostile = counts.copy()
    hostile[:3] = [0, -5, 99]  # clamped to [1, max_blocks], as the TPU kernel
    for nb in (counts, hostile):
        out = np.zeros((32, len(msgs)), dtype=np.uint8)
        host_kernel.host_digest(packed.ctypes.data, nb.ctypes.data, out.ctypes.data, len(msgs), 8)
        plain = tsha.sha256_rows_from_packed(torch.from_numpy(packed), torch.from_numpy(nb))
        np.testing.assert_array_equal(out, plain.numpy().astype(np.uint8))
    assert [out[:, i].tobytes() for i in range(3, len(msgs))] == [
        hashlib.sha256(m).digest() for m in msgs[3:]
    ]


def test_wrapper_routes_cpu_tensors_to_plain_version():
    packed, counts = tsha.pack_frames(_messages(), PINNED)
    p, nb = torch.from_numpy(packed), torch.from_numpy(counts)
    launches, calls = sha256_cuda.launches, tsha.plain_calls
    got = sha256_cuda.digest_rows(p, nb)
    assert got.dtype == torch.uint8 and got.shape == (32, p.shape[1])
    assert sha256_cuda.launches == launches and tsha.plain_calls == calls + 1
    np.testing.assert_array_equal(got.numpy(), tsha.sha256_rows_from_packed(p, nb).numpy())
    with pytest.raises(ValueError):
        sha256_cuda.digest_rows(p.to("meta"), nb)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    msgs = _messages(seed=19) * 40
    packed, counts = tsha.pack_frames(msgs, 8)
    p, nb = torch.from_numpy(packed).cuda(), torch.from_numpy(counts).cuda()
    launches = sha256_cuda.launches
    got = sha256_cuda.digest_rows(p, nb)
    torch.cuda.synchronize()
    assert sha256_cuda.launches == launches + 1
    assert torch.equal(got, tsha.sha256_rows_from_packed(p, nb).to(torch.uint8))
    digests = got.t().contiguous().cpu().numpy()
    assert [d.tobytes() for d in digests] == [hashlib.sha256(m).digest() for m in msgs]
    with pytest.raises(ValueError):
        sha256_cuda.digest_rows(p[:100].contiguous(), nb)  # not a block multiple
    with pytest.raises(ValueError):
        sha256_cuda.digest_rows(p, nb.to(torch.int64))
