"""The port's field arithmetic (stellar_tpu_torch/ops/fe.py) against the JAX
package's (stellar_tpu/ops/fe.py), limb for limb.

Same inputs, made from a seed with numpy/random, go through both; every
output limb must be equal (tolerance: exact — integer arithmetic).  Values
include the edges of tests/test_ed25519_tpu.py (0, 1, 19, p-1, 2^255-20,
2^255-19) and random elements, some given as unreduced limb vectors.
"""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from stellar_tpu.ops import fe as jfe  # noqa: E402
from stellar_tpu_torch.ops import fe as tfe  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

P = jfe.P


def _limbs(vals):
    return np.stack([jfe.int_to_limbs(v) for v in vals], axis=1)


@pytest.fixture(scope="module")
def ab():
    rng = random.Random(5)
    vals = [rng.randrange(P) for _ in range(10)] + [
        0, 1, 19, P - 1, 2**255 - 20, 2**255 - 19,
    ]
    a = _limbs(vals)
    b = a[:, ::-1].copy()
    # weakly-reduced limbs up to MASK + 3, as the hot path produces them
    np_rng = np.random.default_rng(7)
    bump = np_rng.integers(0, 4, size=a.shape, dtype=np.int32)
    bump[:, :4] = 0
    a_weak = a + bump * (a < jfe.MASK - 3)
    return a, b, a_weak


def _same(jax_fn, torch_fn, *arrays):
    want = np.asarray(jax.jit(jax_fn)(*[jnp.asarray(x) for x in arrays]))
    got = torch_fn(*[torch.from_numpy(np.ascontiguousarray(x)) for x in arrays])
    got = got.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "name", ["add", "sub", "mul", "sqr", "neg", "carry", "carry_exact", "canonical"]
)
def test_elementwise_ops_limb_exact(ab, name):
    a, b, a_weak = ab
    jf, tf = getattr(jfe, name), getattr(tfe, name)
    if name in ("add", "sub", "mul"):
        _same(jf, tf, a_weak, b)
    else:
        _same(jf, tf, a_weak)


def test_mul_small_and_chains_limb_exact(ab):
    a, _, a_weak = ab
    _same(lambda x: jfe.mul_small(x, 121666), lambda x: tfe.mul_small(x, 121666), a_weak)
    nz = a.copy()
    nz[:, np.all(nz == 0, axis=0)] = 7  # inv of 0 is 0 on both, but keep it live
    _same(jfe.inv, tfe.inv, nz)
    _same(jfe.pow_p58, tfe.pow_p58, a_weak)


def test_predicates_and_select(ab):
    a, b, _ = ab
    for name in ("is_zero", "parity"):
        _same(getattr(jfe, name), getattr(tfe, name), a)
    _same(jfe.eq, tfe.eq, a, b)
    cond = (np.arange(a.shape[1]) % 3 == 0)
    want = np.asarray(jfe.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)))
    got = tfe.select(torch.from_numpy(cond), torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mul_trailing_dims_limb_exact():
    """fe ops are shape-polymorphic: the (20, 16, N) table shape."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, jfe.MASK + 1, size=(20, 16, 3), dtype=np.int32)
    b = rng.integers(0, jfe.MASK + 1, size=(20, 16, 3), dtype=np.int32)
    _same(jfe.mul, tfe.mul, a, b)
    _same(jfe.sub, tfe.sub, a, b)


@pytest.mark.parametrize("width", [128, 256, 33])
def test_inv_batch_limb_exact(width):
    """The tree (256), the one-level base case (128) and an odd width that
    falls back to inv; a zero lane's slot is garbage on both, identically."""
    rng = random.Random(17 + width)
    vals = [rng.randrange(1, P) for _ in range(width)]
    vals[width // 3] = 0
    z = _limbs(vals)
    _same(lambda x: jfe.inv_batch(x, min_width=64), lambda x: tfe.inv_batch(x, min_width=64), z)
    got = tfe.inv_batch(torch.from_numpy(z), min_width=64).numpy()
    for i, v in enumerate(vals):
        if v:
            assert jfe.limbs_to_int(got[:, i]) % P == pow(v, P - 2, P)


def test_byte_roundtrip_and_constants():
    rng = random.Random(9)
    vals = [rng.randrange(P) for _ in range(6)] + [P - 1, 0]
    bts = np.zeros((32, len(vals)), dtype=np.int32)
    for i, v in enumerate(vals):
        bts[:, i] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    _same(jfe.limbs_from_bytes, tfe.limbs_from_bytes, bts)
    lim = tfe.limbs_from_bytes(torch.from_numpy(bts))
    assert [tfe.limbs_to_int(lim[:, i].numpy()) for i in range(len(vals))] == vals
    back = tfe.bytes_from_limbs(tfe.canonical(lim)).numpy()
    np.testing.assert_array_equal(back, bts)
    _same(jfe.bytes_from_limbs, tfe.bytes_from_limbs, _limbs(vals))
    np.testing.assert_array_equal(tfe.SUB_PAD.numpy(), np.asarray(jfe.SUB_PAD))
    np.testing.assert_array_equal(tfe.P_LIMBS_COL.numpy(), np.asarray(jfe.P_LIMBS_COL))
    np.testing.assert_array_equal(
        tfe.one_fe(3).numpy(), np.asarray(jfe.one_fe(3))
    )
