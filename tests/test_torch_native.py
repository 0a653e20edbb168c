"""The port's native bridge (`zksnark_tpu_torch.curve.native`) and the
field adapters' `eq`.

`available`, `multi_pairing` and `g1_scalar_mul` against the port's
pure-Python curve (`curve.bn254`) and, where the JAX package's native
library loads, against the JAX package's bridge, as
tests/test_native_pairing.py holds the JAX one; each with the native
library and with its Python fallback.  `FqOps.eq` / `Fq2Ops.eq` against
the JAX package's on the same limbs.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from zksnark_tpu.curve import field_ops as jfo  # noqa: E402
from zksnark_tpu.curve import native as jnative  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as c  # noqa: E402
from zksnark_tpu_torch.curve import field_ops as fo  # noqa: E402
from zksnark_tpu_torch.curve import native  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.field.params import R  # noqa: E402

RNG = np.random.default_rng(6)


def _needs_jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's libbn254.so did not build")


def _k():
    return int(RNG.integers(1, 1 << 62)) * int(RNG.integers(1, 1 << 62)) % R


@pytest.fixture(params=["native", "python"])
def bridge(request, monkeypatch):
    """The bridge as it loads, and with its library missing (the Python
    fallback)."""
    if request.param == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.available():
        pytest.skip("the native library did not build here")
    return native


def test_available_matches_load():
    assert native.available() == (native._load() is not None)
    assert isinstance(native.available(), bool)


def test_multi_pairing_matches_python(bridge):
    a, b = _k(), _k()
    P = c.g1_scalar_mul(c.G1_GEN_PT, a)
    Q = c.g2_scalar_mul(c.G2_GEN, b)
    assert bridge.multi_pairing([(P, Q)]) == c.pairing(P, Q)


def test_multi_pairing_of_inverse_pairs_is_one(bridge):
    a, b = _k(), _k()
    P = c.g1_scalar_mul(c.G1_GEN_PT, a)
    Q = c.g2_scalar_mul(c.G2_GEN, b)
    neg = c.g1_neg(c.g1_scalar_mul(c.G1_GEN_PT, a * b % R))
    assert bridge.multi_pairing([(P, Q), (neg, c.G2_GEN)]) == c.FQ12_ONE
    assert bridge.multi_pairing([(None, c.G2_GEN)]) == c.FQ12_ONE


@pytest.mark.parametrize("k", [0, 1, 2, R - 1, R, "random"])
def test_g1_scalar_mul_matches_python(bridge, k):
    k = _k() if k == "random" else k
    P = c.g1_scalar_mul(c.G1_GEN_PT, 7)
    assert bridge.g1_scalar_mul(P, k) == c.g1_scalar_mul(P, k)


def test_g1_scalar_mul_of_infinity(bridge):
    assert bridge.g1_scalar_mul(None, 5) is None


def test_multi_pairing_matches_jax_native():
    _needs_jax_native()
    a, b = _k(), _k()
    P = c.g1_scalar_mul(c.G1_GEN_PT, a)
    Q = c.g2_scalar_mul(c.G2_GEN, b)
    pairs = [(P, Q), (c.G1_GEN_PT, c.G2_GEN)]
    assert native.multi_pairing(pairs) == jnative.multi_pairing(pairs)
    assert native.pairing_check(pairs) == jnative.pairing_check(pairs)


def test_g1_scalar_mul_matches_jax_native():
    _needs_jax_native()
    for k in (0, 3, R - 1, _k(), (1 << 256) + 5):
        assert native.g1_scalar_mul(c.G1_GEN_PT, k) == \
            jnative.g1_scalar_mul(c.G1_GEN_PT, k)


def _limbs(shape, equal_rows):
    """Random limbs (..., 8) with a second tensor equal at `equal_rows`
    and differing in one limb elsewhere."""
    a = RNG.integers(0, 1 << 31, size=shape + (8,), dtype=np.int64)
    b = a.copy()
    flat = b.reshape(-1, 8)
    for i in range(flat.shape[0]):
        if i not in equal_rows:
            flat[i, i % 8] ^= 1 << (i % 31)
    return (torch.from_numpy(a.astype(np.int32)),
            torch.from_numpy(b.astype(np.int32)))


def _jax(t):
    return jnp.asarray(limb.limbs_to_jax_np(t.numpy()))


def test_fq_eq_matches_jax():
    a, b = _limbs((12,), {0, 4, 5, 11})
    got = fo.FQ_OPS.eq(a, b)
    want = np.asarray(jfo.FQ_OPS.eq(_jax(a), _jax(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [i in {0, 4, 5, 11} for i in range(12)]
    assert fo.FQ_OPS.on_kernel().eq(a, a).all()


def test_fq2_eq_matches_jax():
    # an Fq2 element is equal only when both coefficients are
    a, b = _limbs((6, 2), {0, 1, 4, 6, 7, 10})
    got = fo.FQ2_OPS.eq(a, b)
    want = np.asarray(jfo.FQ2_OPS.eq(_jax(a), _jax(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [True, False, False, True, False, False]
