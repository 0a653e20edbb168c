"""The port's Pippenger MSM against the JAX package and the host curve.

`zksnark_tpu_torch.ops.msm.msm` (its point operations on the plain
versions of K2-K4 here) against `zksnark_tpu.ops.msm.msm` and `msm_naive`
for n <= 64, including the adversarial cases of
tests/test_msm_kernels.py: exactly cancelling buckets, all-equal points,
zero scalars, an infinity point, a scalar whose only digit is in the top
window.  The two
packages run the same algorithm on the same residues, so the raw Jacobian
results are compared, as well as the affine result against the host
curve.  Tolerance: exact equality.

Every point is a known multiple k G of the generator, so a host
expectation is one scalar multiplication, (sum k_i s_i) G.  The JAX
package's MSMs run asynchronously: each test dispatches them first and
the port computes meanwhile.
"""

import random

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.curve import jacobian as jjac  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ_OPS as J_FQ  # noqa: E402
from zksnark_tpu.field import limb as jlimb  # noqa: E402
from zksnark_tpu.ops import msm as jmsm  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.field.params import R  # noqa: E402
from zksnark_tpu_torch.ops import msm  # noqa: E402

rng = random.Random(4242)
torch.set_num_threads(1)     # small tensors: threads only add overhead


_G1_POW2 = []                # 2^i G, built on first use


def _g1_mul(k):
    """k G on the host, from the table of 2^i G (one host add per set
    bit)."""
    if not _G1_POW2:
        p = hc.G1_GEN_PT
        for _ in range(256):
            _G1_POW2.append(p)
            p = hc.g1_add(p, p)
    acc = None
    for i in range((k % R).bit_length()):
        if (k % R) >> i & 1:
            acc = hc.g1_add(acc, _G1_POW2[i])
    return acc


def _g1(ks):
    host = [_g1_mul(k) for k in ks]
    return host, jac.from_affine(
        FQ_OPS, torch.from_numpy(FQ_OPS.to_mont_np([p[0] for p in host])),
        torch.from_numpy(FQ_OPS.to_mont_np([p[1] for p in host])))


def _expect_g1(ks, scalars):
    """sum s_i (k_i G) = (sum k_i s_i) G."""
    return _g1_mul(sum(k * s for k, s in zip(ks, scalars)))


def _scalars(vals):
    return torch.from_numpy(limb.FR_CTX.to_limbs_np(vals))


def _to_jax(p):
    return jjac.JPoint(*(jnp.asarray(limb.limbs_to_jax_np(c.numpy()))
                         for c in p))


def _expect(host, scalars, add=hc.g1_add, smul=hc.g1_scalar_mul):
    acc = None
    for pt, s in zip(host, scalars):
        acc = add(acc, smul(pt, s))
    return acc


def _assert_raw_equal(port, jax_pt):
    for c, j in zip(port, jax_pt):
        np.testing.assert_array_equal(limb.limbs_to_jax_np(c.numpy()),
                                      np.asarray(j))


def test_msm_matches_jax_and_host():
    """Random points and scalars at 4-bit windows (what pick_window_bits
    gives for 64 points), with zero scalars, an infinity point and a
    scalar whose only nonzero digit is in the top window."""
    n = 23
    ks = [rng.randrange(1, R) for _ in range(n)]
    _, P = _g1(ks)
    inf = jac.infinity(FQ_OPS, (1,))
    P = jac.JPoint(*(torch.cat([a[:-1], b]) for a, b in zip(P, inf)))
    ks[-1] = 0
    svals = [rng.randrange(R) for _ in range(n)]
    for i in (2, 5, 11, 17):
        svals[i] = 0
    svals[7] = 3 << 252                  # < R: the top window's digit only
    want = jmsm.msm(J_FQ, _to_jax(P), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(svals)), window_bits=4)
    got = msm.msm(FQ_OPS, P, _scalars(svals), window_bits=4)
    _assert_raw_equal(got, want)
    assert jac.to_affine_np(FQ_OPS, got) == _expect_g1(ks, svals)


def test_msm_naive_matches_jax():
    n = 8
    ks = [rng.randrange(1, R) for _ in range(n)]
    _, P = _g1(ks)
    svals = [rng.randrange(R) for _ in range(n)]
    want = jmsm.msm_naive(J_FQ, _to_jax(P), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(svals)))
    got = msm.msm_naive(FQ_OPS, P, _scalars(svals))
    _assert_raw_equal(got, want)
    assert jac.to_affine_np(FQ_OPS, got) == _expect_g1(ks, svals)


def test_msm_cancelling_buckets():
    """Whole buckets (and run-end prefixes) summing to exactly infinity:
    the validity-flag forward fill must not inherit a previous bucket."""
    # one cancelling bucket (3) among populated ones (5, 9), against JAX
    ks2 = [rng.randrange(1, R) for _ in range(6)]
    _, P2 = _g1(ks2)
    neg2 = jac.neg(FQ_OPS, jac.JPoint(*(c[:2] for c in P2)))
    pts2 = jac.JPoint(*(torch.cat([a[:2], b, a[2:]])
                        for a, b in zip(P2, neg2)))
    s2 = [3, 3, 3, 3, 5, 5, 9, 9]
    want = jmsm.msm(J_FQ, _to_jax(pts2), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(s2)), window_bits=4)

    # every bucket cancels (8-bit windows)
    _, P = _g1([rng.randrange(1, R) for _ in range(8)])
    negP = jac.neg(FQ_OPS, P)
    pts = jac.JPoint(*(torch.cat([a, b]) for a, b in zip(P, negP)))
    s = [3, 3, 7, 7, 11, 11, 200, 200]
    assert jac.to_affine_np(FQ_OPS, msm.msm(
        FQ_OPS, pts, _scalars(s + s), window_bits=8)) is None

    got = msm.msm(FQ_OPS, pts2, _scalars(s2), window_bits=4)
    _assert_raw_equal(got, want)
    assert jac.to_affine_np(FQ_OPS, got) == _expect_g1(ks2[2:], [5, 5, 9, 9])


def test_msm_all_equal_points():
    """One giant bucket run per window, every window at its max digit."""
    _, P1 = _g1([12345])
    n = 16
    pts = jac.JPoint(*(c.expand(n, -1).contiguous() for c in P1))
    got = msm.msm(FQ_OPS, pts, _scalars([R - 1] * n), window_bits=8)
    assert jac.to_affine_np(FQ_OPS, got) == _g1_mul(12345 * n * (R - 1))


def test_msm_affine_path_after_batch_normalize():
    """affine=True (mixed adds on batch_normalize'd points, 4-bit
    windows, no padding) against the host."""
    n = 37
    ks = [rng.randrange(1, R) for _ in range(n)]
    _, P = _g1(ks)
    proj = jac.add(FQ_OPS, P, jac.double(FQ_OPS, P))              # 3P
    mask = torch.tensor([i % 11 == 0 for i in range(n)])
    mixed = jac.select(FQ_OPS, mask, jac.infinity(FQ_OPS, (n,)), proj)
    norm = jac.batch_normalize(FQ_OPS, mixed)
    svals = [rng.randrange(R) for _ in range(n)]
    expect = _expect_g1([3 * k if i % 11 else 0 for i, k in enumerate(ks)],
                        svals)
    got = msm.msm_windowed(FQ_OPS, norm, _scalars(svals), 4, affine=True)
    assert jac.to_affine_np(FQ_OPS, got) == expect


def test_g2_msm_vs_host():
    ks = [rng.randrange(1, R) for _ in range(3)]
    host = [hc.g2_scalar_mul(hc.G2_GEN, k) for k in ks]
    P = jac.from_affine(
        FQ2_OPS,
        torch.from_numpy(FQ2_OPS.to_mont_np([list(p[0]) for p in host])),
        torch.from_numpy(FQ2_OPS.to_mont_np([list(p[1]) for p in host])))
    svals = [rng.randrange(R) for _ in range(3)]
    got = jac.to_affine_np(FQ2_OPS, msm.msm_windowed(
        FQ2_OPS, P, _scalars(svals), 4, affine=True))
    want = _expect(host, svals, hc.g2_add, hc.g2_scalar_mul)
    assert tuple(map(tuple, got)) == want


@pytest.mark.parametrize("c", [4, 8, 11, 16])
def test_digit_columns_match_jax(c):
    svals = [rng.randrange(R) for _ in range(9)] + [R - 1, 0]
    got = msm._digit_columns(_scalars(svals), c)
    want = jmsm._digit_columns(jnp.asarray(jlimb.FR_CTX.to_limbs_np(svals)), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert msm.pick_window_bits(1 << 20) == jmsm.pick_window_bits(1 << 20)
