"""The MSM's tail (`add_gather`, `abel` in `zksnark_tpu_torch.ops.
curve_kernels`) against the JAX package and against the composition the
port ran before them, on G1 and G2.

On CPU tensors the wrappers run their plain versions; those must equal,
in raw Jacobian coordinates,
- JAX `jacobian.add` on the same gathered operands (rows of two point
  tables, infinity for an index < 0), for `add_gather`;
- JAX `jacobian.add`, `msm._double_n`, `jacobian.neg` and `jacobian.add`
  composed as the JAX MSM's Abel step, for `abel`;
- the tail as the port ran it before (chunked add scans of 64 steps,
  Hillis-Steele rounds over materialized shifted concatenations,
  broadcasts, a gather of the bucket ends and a select of infinity, then
  elementwise adds and `double_n`), for `msm._prefix_scan` and
  `msm._bucket_windows_sorted` at the tail's toy shapes (n = 2^8, c = 4).
  Where one block of one step a thread covers the scan, the block scan's
  rounds are the Hillis-Steele rounds, so raw Jacobian coordinates are
  equal; otherwise the block scans associate the adds otherwise, so the
  results, of real curve points, are compared in affine form, with the
  old composition and with the host curve's running sums.
The cases: indices < 0 on either side and on both (the canonical
infinity), equal points that meet only through the gather (the doubling
branch reads P's row again), P = -Q, infinity rows, a bucket whose points
cancel, windows whose leading buckets are empty, and equal chunk and
block totals.  The off-curve rows are random canonical residues: the
formulas and their branches act on them as on real points.
Tolerance: exact equality.
"""

import random
from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.curve import jacobian as jjac  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ2_OPS as J_FQ2  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ_OPS as J_FQ  # noqa: E402
from zksnark_tpu.ops import msm as jmsm  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.field.params import R  # noqa: E402
from zksnark_tpu_torch.ops import curve_kernels as ck  # noqa: E402
from zksnark_tpu_torch.ops import msm  # noqa: E402

torch.set_num_threads(1)     # small tensors: threads only add overhead

GROUPS = {"g1": (FQ_OPS, J_FQ, hc.G1_GEN_PT, hc.g1_add, hc.g1_neg,
                 hc.g1_scalar_mul),
          "g2": (FQ2_OPS, J_FQ2, hc.G2_GEN, hc.g2_add, hc.g2_neg,
                 hc.g2_scalar_mul)}
K = 4                        # Abel's doublings at c = 4
JIT = {}                     # one jit per JAX function and group


def _jax(group, name):
    """The JAX functions, each jitted once per group."""
    if (group, name) not in JIT:
        jops = GROUPS[group][1]
        fns = {"add": partial(jjac.add, jops),
               "abel": lambda c, t, r: jjac.add(
                   jops, jmsm._double_n(jops, jjac.add(jops, c, t), K),
                   jjac.neg(jops, r))}
        JIT[group, name] = jax.jit(fns[name])
    return JIT[group, name]


def _to_jax(p):
    return jjac.JPoint(*(jnp.asarray(limb.limbs_to_jax_np(c.numpy()))
                         for c in p))


def _raw_equal_jax(port, jax_pt):
    for c, j in zip(port, jax_pt):
        np.testing.assert_array_equal(limb.limbs_to_jax_np(c.numpy()),
                                      np.asarray(j))


def _raw_equal(a, b):
    for u, v in zip(a, b):
        assert u.shape == v.shape
        assert torch.equal(u, v)


def _cat(*ps):
    return jac.JPoint(*(torch.cat(c) for c in zip(*ps)))


def _rows(p, idx):
    return jac.JPoint(*(c[list(idx)] for c in p))


class Pts:
    """Point makers for one group: real points from the host curve (None
    = infinity, Z in {0, one}, or rescaled to another Z) and random
    canonical residues."""

    def __init__(self, group, seed):
        self.group = group
        self.ops, _, self.gen, self.add, self.neg, self.smul = GROUPS[group]
        self.rng = np.random.default_rng(seed)
        self.hrng = random.Random(seed)

    def host(self, k):
        return self.smul(self.gen, k)

    def real(self, host, lams=None):
        ops, g1 = self.ops, self.group == "g1"
        zero = 0 if g1 else [0, 0]
        x = [zero if h is None else (h[0] if g1 else list(h[0]))
             for h in host]
        y = [zero if h is None else (h[1] if g1 else list(h[1]))
             for h in host]
        inf = torch.tensor([h is None for h in host])
        p = jac.JPoint(torch.from_numpy(ops.to_mont_np(x)),
                       torch.from_numpy(ops.to_mont_np(y)),
                       ops.select(inf, ops.zero((len(host),)),
                                  ops.one((len(host),))))
        if lams is None:
            return p
        lm = torch.from_numpy(ops.to_mont_np(
            lams if g1 else [[v, 0] for v in lams]))
        l2 = ops.mul(lm, lm)
        return jac.JPoint(ops.mul(p.x, l2), ops.mul(p.y, ops.mul(l2, lm)),
                          ops.mul(p.z, lm))

    def residues(self, shape):
        q = limb.FQ_CTX.p
        ext = shape + (() if self.group == "g1" else (2,))
        vals = [self.hrng.randrange(q) for _ in range(int(np.prod(ext)))]
        return torch.from_numpy(limb.FQ_CTX.to_limbs_np(
            np.array(vals, dtype=object).reshape(ext)))

    def random(self, shape, z=None):
        """Random residues; Z random, or `z` ("one": the affine one)."""
        zc = (self.ops.one(shape).contiguous() if z == "one"
              else self.residues(shape))
        return jac.JPoint(self.residues(shape), self.residues(shape), zc)

    def affine(self, host_pts):
        aff = jac.to_affine_np(self.ops, host_pts)
        if self.group == "g1":
            return list(aff)
        return [None if a is None else tuple(map(tuple, a)) for a in aff]


@pytest.fixture(scope="module", params=["g1", "g2"])
def pts(request):
    return Pts(request.param, 11 if request.param == "g1" else 12)


# ---------------------------------------------------------------------------
# add_gather and abel against the JAX package
# ---------------------------------------------------------------------------

def _gather_case(pts):
    """Two tables and 16 index pairs over them; the host sums of the
    rows of real points, by row."""
    A, B, C, D = (pts.host(pts.hrng.randrange(1, R)) for _ in range(4))
    P = _cat(pts.real([A, B, C, D], [3, 1, 1, 9]), pts.real([None]),
             pts.random((5,)))
    Q = _cat(pts.real([A, pts.neg(B)], [5, 1]), pts.random((4,)),
             pts.real([None, D]))
    #        A+A  B-B  .+q2 p5+. .+.  inf  C+D  D+D  random rows
    pi = [0, 1, -1, 5, -1, 4, 2, 3, 6, 6, 7, 8, 9, 5, -1, 9]
    qi = [0, 1, 2, -1, -1, 3, 7, 7, 2, 3, 4, 5, 2, 6, 5, -1]
    host = {0: pts.add(A, A), 1: None, 4: None, 6: pts.add(C, D),
            7: pts.add(D, D)}
    return P, torch.tensor(pi, dtype=torch.int32), Q, \
        torch.tensor(qi, dtype=torch.int32), host


def _gathered(pts, table, idx):
    """Rows of `table`, infinity for idx < 0, by hand (numpy indexing)."""
    inf = jac.infinity(pts.ops, (1,))
    ext = _cat(table, jac.JPoint(*(c.contiguous() for c in inf)))
    n = table.z.shape[0]
    return _rows(ext, [n if i < 0 else i for i in idx.tolist()])


def test_add_gather_equals_jax_add(pts):
    P, pi, Q, qi, host = _gather_case(pts)
    before = dict(ck.LAUNCHES)
    got = ck.add_gather(pts.ops, P, pi, Q, qi)
    assert ck.LAUNCHES == before       # CPU tensors run the plain version
    a, b = _gathered(pts, P, pi), _gathered(pts, Q, qi)
    _raw_equal_jax(got, _jax(pts.group, "add")(_to_jax(a), _to_jax(b)))
    assert pts.affine(_rows(got, host)) == list(host.values())
    # both indices < 0: the canonical infinity, limb for limb
    _raw_equal(_rows(got, [4]), jac.infinity(pts.ops, (1,)))


def test_add_gather_one_table_equals_jax_add(pts):
    """P and Q the same table, as in a Hillis-Steele round: rows equal to
    themselves (the doubling branch re-reads P's row), the previous row,
    infinity before the start; and an index shape of (4, 4)."""
    P = pts.random((16,))
    pi = torch.tensor([-1, 0, 2, 3, 3, 4, 5, 0, 7, 9, 9, 10, 11, 12, 15, 14],
                      dtype=torch.int32)
    qi = torch.arange(16, dtype=torch.int32)
    got = ck.add_gather(pts.ops, P, pi.reshape(4, 4), P, qi.reshape(4, 4))
    assert got.z.shape[:2] == (4, 4)
    flat = jac.JPoint(*(c.reshape((16,) + c.shape[2:]) for c in got))
    want = _jax(pts.group, "add")(_to_jax(_gathered(pts, P, pi)),
                                  _to_jax(_gathered(pts, P, qi)))
    _raw_equal_jax(flat, want)
    # row 2 + row 2 is the doubling of row 2
    _raw_equal(_rows(flat, [2]), ck.double_plain(pts.ops, _rows(P, [2])))


def _abel_case(pts):
    """16 windows' (C, T, R) and the host results of rows 0-4: 2A - B
    with A met twice (the first add doubles), an infinite E_top, C at
    infinity and R at infinity, R = 2^K E_top (the last add cancels),
    R = -2^K E_top (the last add doubles); rows 5-15 random residues."""
    A, B, C, D = (pts.host(pts.hrng.randrange(1, R)) for _ in range(4))
    top = pts.smul(pts.add(A, B), 1 << K)
    c = _cat(pts.real([A, B, None, A, A], [2, 1, 1, 1, 7]),
             pts.random((11,)))
    t = _cat(pts.real([A, pts.neg(B), D, B, B], [3, 1, 1, 5, 1]),
             pts.random((11,)))
    r = _cat(pts.real([B, C, None, top, pts.neg(top)], [1, 4, 1, 6, 1]),
             pts.random((11,)))
    host = [pts.add(pts.smul(A, 2 << K), pts.neg(B)), pts.neg(C),
            pts.smul(D, 1 << K), None, pts.smul(top, 2)]
    return c, t, r, host


def test_abel_equals_jax_composition(pts):
    c, t, r, host = _abel_case(pts)
    before = dict(ck.LAUNCHES)
    got = ck.abel(pts.ops, c, t, r, K)
    assert ck.LAUNCHES == before
    _raw_equal_jax(got, _jax(pts.group, "abel")(_to_jax(c), _to_jax(t),
                                               _to_jax(r)))
    assert pts.affine(_rows(got, range(5))) == host


def test_abel_equals_old_composition(pts):
    """The launches it replaced: add, double_n, jacobian.neg, add."""
    c, t, r, _ = _abel_case(pts)
    ops = pts.ops
    old = ck.add(ops, ck.double_n(ops, ck.add(ops, c, t), K),
                 jac.neg(ops, r))
    _raw_equal(ck.abel(ops, c, t, r, K), old)
    _raw_equal(ck.abel(ops, c, t, r, 0),
               ck.add(ops, ck.add(ops, c, t), jac.neg(ops, r)))


def test_tail_entries_reject_bad_arguments(pts):
    ops = pts.ops
    P = pts.random((4,))
    i32 = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ck.add_gather(ops, P, i32.long(), P, i32)
    with pytest.raises(ValueError, match="one shape"):
        ck.add_gather(ops, P, i32, P, i32[:3])
    with pytest.raises(ValueError, match="k = -1"):
        ck.abel(ops, P, P, P, -1)
    with pytest.raises(ValueError, match="one shape"):
        ck.abel(ops, P, P, _rows(P, [0, 1]), 1)
    meta = jac.JPoint(*(torch.empty(a.shape, dtype=a.dtype, device="meta")
                        for a in P))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.abel(ops, meta, meta, meta, 1)


# ---------------------------------------------------------------------------
# the tail against the composition it replaced
# ---------------------------------------------------------------------------

def _old_scan_chunks(ops, pts, c, collect):
    n = pts.z.shape[0]
    b = -(-n // c)
    pts = msm._pad_to(ops, pts, b * c)
    return ck.add_scan(ops, jac.JPoint(*(a.reshape((b, c) + a.shape[1:])
                                         for a in pts)), collect)


def _old_tree_sum(ops, pts):
    while pts.z.shape[0] > 1:
        pts, _ = _old_scan_chunks(ops, pts, min(64, pts.z.shape[0]), False)
    return msm._index(pts, 0)


def _old_hs_scan(ops, pts):
    size = pts.z.shape[0]
    if size <= 1:
        return pts
    rest = msm._batch_shape(ops, pts)[1:]
    for i in range((size - 1).bit_length()):
        shift = 1 << i
        inf = jac.infinity(ops, (min(shift, size),) + rest)
        partner = msm._cat(inf, msm._index(pts, slice(0, size - shift)))
        pts = ck.add(ops, partner, pts)
    return pts


def _old_prefix_scan(ops, pts):
    n = pts.z.shape[0]
    if n <= 2 * msm._CHUNK:
        return _old_hs_scan(ops, pts)
    totals, within = _old_scan_chunks(ops, pts, msm._CHUNK, collect=True)
    b = totals.z.shape[0]
    rest = msm._batch_shape(ops, totals)[1:]
    shifted = msm._cat(jac.infinity(ops, (1,) + rest),
                       msm._index(totals, slice(0, b - 1)))
    carry = _old_prefix_scan(ops, shifted)
    full = ck.add(ops, jac.JPoint(*(a.unsqueeze(1) for a in carry)), within)
    full = jac.JPoint(*(a.reshape((b * msm._CHUNK,) + a.shape[2:])
                        for a in full))
    return msm._index(full, slice(0, n))


def _old_bucket_windows_sorted(ops, pts, order, d_sorted, num_buckets,
                               affine):
    W, n = order.shape
    elem = pts.x.shape[1:]
    cdim = min(msm._CHUNK, n)
    b = -(-n // cdim)
    ends_w, bucket_chunk, valid, totals = ck.bucket_scan(
        ops, pts, order, d_sorted, num_buckets, cdim, affine)
    shifted = msm._cat(jac.infinity(ops, (1, W)),
                       msm._index(totals, slice(0, b - 1)))
    carry = _old_prefix_scan(ops, shifted)
    carry_rows = msm._pack(carry, (b * W,))
    ends_c = msm._unpack(carry_rows[bucket_chunk * W + torch.arange(
        W).unsqueeze(1)], elem)
    ends = ck.add(ops, ends_c, ends_w)
    src = torch.where(valid, torch.arange(num_buckets),
                      torch.full((), -1, dtype=torch.int64))
    last_valid = torch.cummax(src, dim=1).values
    filled = msm._unpack(torch.gather(
        msm._pack(ends, (W, num_buckets)), 1,
        last_valid.clamp(min=0).unsqueeze(-1).expand(
            -1, -1, 3 * ends.x[0, 0].numel())), elem)
    filled = jac.select(ops, last_valid < 0,
                        jac.infinity(ops, (W, num_buckets)), filled)
    e_top = ck.add(ops, msm._index(carry, b - 1), msm._index(totals, b - 1))
    lhs = ck.double_n(ops, e_top, num_buckets.bit_length() - 1)
    rhs = _old_tree_sum(ops, jac.JPoint(*(a.transpose(0, 1)
                                          for a in filled)))
    return ck.add(ops, lhs, jac.neg(ops, rhs))


def _chain(pts, n):
    """n real points P_0 + k D (host), k = 0 .. n - 1."""
    cur, step = pts.host(pts.hrng.randrange(1, R)), \
        pts.host(pts.hrng.randrange(1, R))
    out = []
    for _ in range(n):
        out.append(cur)
        cur = pts.add(cur, step)
    return out


def test_hs_scan_equals_old(pts):
    """5 positions x 3 lanes, one block of one step a thread: the block
    scan's rounds are the Hillis-Steele rounds, raw.  Lane 0 holds one
    point twice in a row (round 0 doubles it), lane 1 a point and its
    negation, lane 2 an infinity."""
    p = pts.random((5, 3))
    for c in p:
        c[1, 0] = c[0, 0]
    p.y[2, 1] = pts.ops.neg(p.y[1, 1])
    p.x[2, 1], p.z[2, 1] = p.x[1, 1], p.z[1, 1]
    p.z[3, 2] = 0
    assert ck.block_scan_shape(5, 3) == (8, 1)
    _raw_equal(msm._prefix_scan(pts.ops, p), _old_hs_scan(pts.ops, p))


def test_prefix_scan_equals_old(pts):
    """2^8 positions x 2 lanes of real points with Z rescaled (four
    blocks of 64: the block totals' scan and the fix-up that adds each
    block's carry), with infinities, and lane 1's chunks of 64 identical
    so that its block totals are equal; in affine form against the old
    composition (four chunks of 64) and the host's running sums."""
    n = 256
    assert ck.block_scan_shape(n, 2) == (64, 1)
    host = _chain(pts, n + 64)
    mask = pts.rng.random(n) < 1 / 16
    lane0 = [None if m else h for m, h in zip(mask, host[:n])]
    lane1 = host[n:] * 4
    grid = [h for pair in zip(lane0, lane1) for h in pair]
    flat = pts.real(grid, [pts.hrng.randrange(1, 1 << 60)
                           for _ in grid])
    p = jac.JPoint(*(a.reshape((n, 2) + a.shape[1:]) for a in flat))
    got = msm._prefix_scan(pts.ops, p)
    assert got.z.shape == p.z.shape
    want, acc = [], [None, None]
    for a, b in zip(lane0, lane1):
        acc = [pts.add(acc[0], a), pts.add(acc[1], b)]
        want += acc
    flat_of = (lambda q: jac.JPoint(*(a.reshape((2 * n,) + a.shape[2:])
                                      for a in q)))
    assert pts.affine(flat_of(got)) == want
    assert pts.affine(flat_of(_old_prefix_scan(pts.ops, p))) == want


def test_bucket_windows_equal_old(pts):
    """n = 2^8 real points, c = 4 (16 buckets), mixed adds over an
    affine-or-infinity table, four windows: digits in [5, 16) only (five
    empty leading buckets), a bucket of a point and its negation (it
    cancels) beside random digits, every point in bucket 9 (equal chunk
    totals: the table repeats one chunk of 64 points), and random digits;
    in affine form against the old composition and the host curve's
    sum_i d_i P_i."""
    n, nb = 256, 16
    host = _chain(pts, 64)
    host[13] = None
    host[1] = pts.neg(host[0])
    host = host * 4
    p = pts.real(host)
    rng = np.random.default_rng(3)
    digits = np.stack([rng.integers(5, nb, n), rng.integers(0, nb, n),
                       np.full(n, 9), rng.integers(0, nb, n)])
    digits[1, 2:] = np.where(digits[1, 2:] == 7, 8, digits[1, 2:])
    digits[1, :2] = 7
    d_sorted, order = torch.sort(torch.from_numpy(digits), dim=1,
                                 stable=True)
    args = (pts.ops, p, order, d_sorted, nb, True)
    got = msm._bucket_windows_sorted(*args)
    assert got.z.shape[0] == 4
    want = []
    for w in range(4):
        acc = None
        for h, d in zip(host, digits[w].tolist()):
            if h is not None and d:
                acc = pts.add(acc, pts.smul(h, d))
        want.append(acc)
    assert pts.affine(got) == want
    assert pts.affine(_old_bucket_windows_sorted(*args)) == want
