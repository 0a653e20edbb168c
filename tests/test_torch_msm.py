"""The port's Pippenger MSM against the JAX package and the host curve.

`zksnark_tpu_torch.ops.msm.msm` (its point operations on the plain
versions of K2-K4 here) against `zksnark_tpu.ops.msm.msm` and `msm_naive`
for n <= 64, including the adversarial cases of
tests/test_msm_kernels.py: exactly cancelling buckets, all-equal points,
zero scalars, an infinity point, a scalar whose only digit is in the top
window.  The two
packages run the same algorithm on the same residues, but the port's
tail (its block scans) associates the adds otherwise, so its result is
another Jacobian representative of the JAX package's point: the results
are compared in affine form, with each other and against the host curve.
Tolerance: exact equality.

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


def _assert_group_equal(port, jax_pt):
    """The same point in affine form (None: infinity)."""
    assert jac.to_affine_np(FQ_OPS, port) == jac.to_affine_np(
        FQ_OPS, jac.JPoint(*(torch.from_numpy(limb.limbs_from_jax_np(
            np.asarray(c))) for c in jax_pt)))


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
    _assert_group_equal(got, want)
    assert jac.to_affine_np(FQ_OPS, got) == _expect_g1(ks, svals)


def test_msm_naive_matches_jax():
    n = 8
    ks = [rng.randrange(1, R) for _ in range(n)]
    _, P = _g1(ks)
    svals = [rng.randrange(R) for _ in range(n)]
    want = jmsm.msm_naive(J_FQ, _to_jax(P), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(svals)))
    got = msm.msm_naive(FQ_OPS, P, _scalars(svals))
    _assert_group_equal(got, want)
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
    _assert_group_equal(got, want)
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


# ---------------------------------------------------------------------------
# fixed-base window tables (`msm.window_table`, `msm.msm_tables`)
# ---------------------------------------------------------------------------

# 64 rows: k_i P for i < 30, their negatives, then 4 infinity rows (the
# padding of the prover's sets); c = 4, and c = 5, whose windows straddle
# the scalars' 32-bit limbs
TABLE_N, TABLE_PAIRS = 64, 30
GROUPS = {"g1": (FQ_OPS, hc.G1_GEN_PT, hc.g1_scalar_mul),
          "g2": (FQ2_OPS, hc.G2_GEN, hc.g2_scalar_mul)}
_tables = {}


def _table_points(group):
    """(ks, the host points, the 64 device points) of the group: the
    host scalars k_i (0 on infinity rows) of the rows k_i P."""
    ops, gen, smul = GROUPS[group]
    trng = random.Random(7)
    ks = [trng.randrange(1, 1 << 64) for _ in range(TABLE_PAIRS)]
    ks = ks + [-k for k in ks]
    ks += [0] * (TABLE_N - len(ks))
    host = [smul(gen, k % R) if k else None for k in ks]
    if group == "g1":
        pts = jac.JPoint(*(torch.cat([a, b]) for a, b in zip(
            _g1(ks[:2 * TABLE_PAIRS])[1],
            jac.infinity(ops, (TABLE_N - 2 * TABLE_PAIRS,)))))
    else:
        from zksnark_tpu_torch.groth16.prover import _host_points_to_jac
        pts = _host_points_to_jac(ops, host, "cpu")
    return ks, host, pts


def _table(group, c):
    """The group's 64 points and their window table at c bits, built once
    a (group, c)."""
    if (group, c) not in _tables:
        ks, host, pts = _table_points(group)
        _tables[group, c] = (ks, host, pts,
                             msm.window_table(GROUPS[group][0], pts, c))
    return _tables[group, c]


def _flat(table):
    return jac.JPoint(*(a.reshape((-1,) + a.shape[2:]) for a in table))


def _table_scalars(case, c):
    """64 scalars of one case (unreduced: a table reads all 256 bits)."""
    srng = random.Random(f"{case}/{c}")
    top = c * (msm.table_windows(c) - 1)       # the top window's first bit
    if case == "full_width":
        return [srng.randrange(R) for _ in range(TABLE_N)]
    if case == "zero_one":
        return [srng.randrange(2) for _ in range(TABLE_N)]
    if case == "all_zero":
        return [0] * TABLE_N
    if case == "top_window":
        return [srng.randrange(1, 1 << (256 - top)) << top
                for _ in range(TABLE_N)]
    if case == "infinity_rows":
        # full-width scalars on the infinity rows and two finite rows
        s = [0] * TABLE_N
        for i in [0, 7] + list(range(2 * TABLE_PAIRS, TABLE_N)):
            s[i] = srng.randrange(R)
        return s
    # cancelling: rows 0-9 and their negatives share 3 digit patterns
    # (whole buckets sum to exactly infinity), rows 10-29 stand alone
    s = [0] * TABLE_N
    for i in range(10):
        s[i] = s[i + TABLE_PAIRS] = (3, 1 << 200, R - 1)[i % 3]
    for i in range(10, TABLE_PAIRS):
        s[i] = srng.randrange(R)
    return s


TABLE_CASES = ["full_width", "zero_one", "all_zero", "top_window",
               "infinity_rows", "cancelling"]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("c", [4, 5])
def test_window_table_blocks(group, c):
    """Block w of the table is 2^(c w) P on the host, at a few rows of a
    few blocks, and every row is affine-or-infinity (Z 0 or one)."""
    ops, _, smul = GROUPS[group]
    ks, host, pts, table = _table(group, c)
    W = msm.table_windows(c)
    assert table.z.shape[:2] == (W, TABLE_N)
    for a, b in zip(table, pts):
        assert torch.equal(a[0], b)
    z = _flat(table).z
    one = ops.one(z.shape[:1], "cpu")
    assert bool((ops.is_zero(z) | (z == one).flatten(1).all(1)).all())
    rows = [0, 13, TABLE_PAIRS + 13, TABLE_N - 1]
    for w in (1, W // 2, W - 1):
        got = jac.to_affine_np(ops, jac.JPoint(*(a[w, rows] for a in table)))
        want = [None if host[i] is None else smul(host[i], (1 << c * w) % R)
                for i in rows]
        if group == "g2":
            got = [None if p is None else tuple(map(tuple, p)) for p in got]
        assert list(got) == want


@pytest.mark.parametrize("case", TABLE_CASES)
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("c", [4, 5])
def test_table_msm_matches_host(group, c, case):
    """One window over the table's W N rows gives sum_i s_i (k_i P):
    on the host, (sum_i k_i s_i) P."""
    ops, gen, smul = GROUPS[group]
    ks, _, _, table = _table(group, c)
    svals = _table_scalars(case, c)
    (got,) = msm.msm_tables(ops, [(_flat(table), [_scalars(svals)])], c)
    k = sum(a * b for a, b in zip(ks, svals)) % R
    want = smul(gen, k) if k else None
    got = jac.to_affine_np(ops, got)
    if group == "g2" and got is not None:
        got = tuple(map(tuple, got))
    assert got == want


def test_table_msm_matches_jax():
    """Table MSMs against JAX `msm` (64 points, 4-bit windows, full-width
    scalars, the shape `test_msm_matches_jax_and_host` compiles) over
    tables at c = 4 and at c = 5 (windows across the limbs), and against
    JAX `msm_naive` (8 points: 4 and their negatives, cancelling scalars,
    the shape `test_msm_naive_matches_jax` compiles), in affine form; two
    groups over one table (each its own sort and bucket scan, the three
    MSMs' tails in one pass) and the port's windowed MSM on the same
    points."""
    ks, _, pts, table = _table("g1", 4)
    s_full, s_bits = (_table_scalars(case, 4)
                      for case in ("full_width", "zero_one"))
    rows = [0, 1, 2, 3, TABLE_PAIRS, TABLE_PAIRS + 1, TABLE_PAIRS + 2,
            TABLE_PAIRS + 3]
    eight = jac.JPoint(*(a[rows] for a in pts))
    s_eight = [3, 1 << 200, R - 1, 5, 3, 1 << 200, R - 1, 7]
    # dispatched first: the JAX package computes while the port does
    want_msm = jmsm.msm(J_FQ, _to_jax(pts), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(s_full)), window_bits=4)
    want_naive = jmsm.msm_naive(J_FQ, _to_jax(eight), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(s_eight)))
    got = msm.msm_tables(FQ_OPS, [
        (_flat(table), [_scalars(s_full), _scalars(s_bits)]),
        (_flat(table), [_scalars(s_full)])], 4)
    (got8,) = msm.msm_tables(FQ_OPS, [(_flat(msm.window_table(
        FQ_OPS, eight, 4)), [_scalars(s_eight)])], 4)
    (got5,) = msm.msm_tables(FQ_OPS, [(_flat(_table("g1", 5)[3]),
                                       [_scalars(s_full)])], 5)
    windowed = msm.msm_windowed(FQ_OPS, pts, _scalars(s_full), 4, True)
    _assert_group_equal(got[0], want_msm)
    _assert_group_equal(got5, want_msm)
    _assert_group_equal(got8, want_naive)
    assert jac.to_affine_np(FQ_OPS, got[0]) == jac.to_affine_np(
        FQ_OPS, got[2]) == jac.to_affine_np(FQ_OPS, windowed)
    assert jac.to_affine_np(FQ_OPS, got[1]) == _expect_g1(ks, s_bits)
    assert jac.to_affine_np(FQ_OPS, got8) == _expect_g1(
        [ks[i] for i in rows], s_eight)
