"""The port's bucket scan against the JAX package, on G1 and G2.

`zksnark_tpu_torch.ops.msm._bucket_windows_sorted` runs the bucket scan
(`curve_kernels.bucket_scan`: its plain version on CPU tensors) and then
the chunk carries, the bucket ends, the forward fill and Abel; its (W,)
window sums must equal JAX `zksnark_tpu.ops.msm._bucket_window_sorted`
mapped over the windows, given the same sort permutation and sorted
digits (made with numpy and handed to both), and the host curve's
sum_k d_k P_k, in affine form (the port's carries and tree sum are block
scans, which associate the adds otherwise than JAX's chunked scans).
The bucket scan's own outputs (slots, chunk indices, validity, chunk
totals), whose adds are JAX's in JAX's order, are held to the host
curve.

Cases: n = 2^8 points and n = 229 (not a multiple of 64: the last chunk
runs past n), c = 4 and c = 8, each group at both n and both c, with
mixed adds over an affine-or-infinity table.  Window 0 opens with a
bucket whose two points cancel exactly (P, -P: madd's P = -Q branch, a
valid bucket whose slot is infinity), then a bucket of three equal points
(madd's doubling branch), leaves some buckets empty and draws the rest
at random; window 1 puts nearly every point in the top bucket, one run
across every chunk.  The table holds infinity entries, some with the X
and Y of a real point.  Tolerance: exact equality.
"""

import random
from concurrent.futures import ThreadPoolExecutor

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
from zksnark_tpu_torch.ops import curve_kernels as ck  # noqa: E402
from zksnark_tpu_torch.ops import msm  # noqa: E402

torch.set_num_threads(1)     # small tensors: threads only add overhead

GROUPS = {"g1": (FQ_OPS, J_FQ, hc.G1_GEN_PT, hc.g1_add, hc.g1_neg,
                 hc.g1_scalar_mul),
          "g2": (FQ2_OPS, J_FQ2, hc.G2_GEN, hc.g2_add, hc.g2_neg,
                 hc.g2_scalar_mul)}
CASES = [("g1", 256, 4), ("g1", 229, 8), ("g2", 256, 8), ("g2", 229, 4)]
W = 2
CANCEL = (20, 21)            # T[21] = -T[20], window 0's digit 0
EQUAL = (10, 11, 12)         # one point three times, window 0's digit 1
INF_ONE = (30, 228)          # infinity as (one, one, 0)
INF_XY = (31, 40)            # infinity with a real point's X and Y


def _table(group, n, seed):
    """(host points, None at infinity; port JPoint with Z in {0, one})."""
    ops, _, gen, add, neg, smul = GROUPS[group]
    rng = random.Random(seed)
    step = smul(gen, rng.randrange(1, limb.FR_CTX.p))
    cur = smul(gen, rng.randrange(1, limb.FR_CTX.p))
    host = []
    for _ in range(n):
        host.append(cur)
        cur = add(cur, step)
    for i in EQUAL[1:]:
        host[i] = host[EQUAL[0]]
    host[CANCEL[1]] = neg(host[CANCEL[0]])
    xy = list(host)
    g1 = group == "g1"
    one = 1 if g1 else [1, 0]
    for i in INF_ONE:
        xy[i] = (one, one)
    for i in INF_ONE + INF_XY:
        host[i] = None

    def coord(k):
        return torch.from_numpy(ops.to_mont_np(
            [p[k] if g1 else list(p[k]) for p in xy]))

    inf = torch.tensor([h is None for h in host])
    z = ops.select(inf, ops.zero((n,)), ops.one((n,)))
    return host, jac.JPoint(coord(0), coord(1), z)


def _digits(n, c, seed):
    """(W, n) digit columns: see the module docstring."""
    nb = 1 << c
    rng = np.random.default_rng(seed)
    d = np.empty((W, n), dtype=np.int64)
    free = np.setdiff1d(np.arange(2, nb), [3, nb // 2, nb - 2])  # 3 empty
    d[0] = rng.choice(free, size=n)
    d[0, list(CANCEL)] = 0
    d[0, list(EQUAL)] = 1
    d[1] = nb - 1
    few = rng.choice(n, size=5, replace=False)
    d[1, few] = rng.integers(0, nb, size=5)
    return d


def _to_jax(p):
    return jjac.JPoint(*(jnp.asarray(limb.limbs_to_jax_np(c.numpy()))
                         for c in p))


def _from_jax(jax_pt):
    return jac.JPoint(*(torch.from_numpy(limb.limbs_from_jax_np(
        np.asarray(c))) for c in jax_pt))


def _affine(ops, p):
    """A (k,) batch as host points: affine tuples, None at infinity."""
    return list(jac.to_affine_np(ops, p))


def _prepare(group, n, c):
    """The table, the sorted digits and the JAX window sums (dispatched:
    they run while the port computes)."""
    jops = GROUPS[group][1]
    seed = n + c + (0 if group == "g1" else 100)
    host, P = _table(group, n, seed)
    d = _digits(n, c, seed)
    order = np.argsort(d, axis=1, kind="stable")
    d_sorted = np.take_along_axis(d, order, axis=1)
    jp = _to_jax(P)
    elem = jp.x.shape[1:]

    @jax.jit
    def jax_sums(packed, o, ds):
        return jax.vmap(lambda oo, dd: jmsm._bucket_window_sorted(
            jops, packed, elem, oo, dd, 1 << c, True))(o, ds)

    want = jax_sums(jmsm._pack_points(jops, jp),
                    jnp.asarray(order, jnp.int32),
                    jnp.asarray(d_sorted, jnp.int32))
    return (group, n, c, host, P, torch.from_numpy(order),
            torch.from_numpy(d_sorted), want)


@pytest.fixture(scope="module")
def prepared():
    """Every case prepared at once, one thread each: XLA compiles the four
    JAX programs side by side."""
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(lambda a: _prepare(*a), CASES)))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{g}-n{n}-c{c}" for g, n, c in CASES])
def case(request, prepared):
    return prepared[request.param]


def test_window_sums_match_jax(case):
    group, n, c, host, P, order, d_sorted, want = case
    ops = GROUPS[group][0]
    before = dict(ck.LAUNCHES)
    got = msm._bucket_windows_sorted(ops, P, order, d_sorted, 1 << c, True)
    assert ck.LAUNCHES == before       # CPU tensors run the plain version
    add, smul = GROUPS[group][3], GROUPS[group][5]
    sums = []
    for w in range(W):
        acc = None
        for k, d in zip(order[w].tolist(), d_sorted[w].tolist()):
            if host[k] is not None and d:
                acc = add(acc, smul(host[k], d))
        sums.append(acc)
    assert _affine(ops, got) == _affine(ops, _from_jax(want)) == sums


def test_bucket_scan_outputs_match_host(case):
    """Slot (w, d) holds the running sum of its chunk up to the end of
    digit d's run, bucket_chunk that chunk and valid whether d occurs;
    totals (B, W) each chunk's sum: checked on the host curve."""
    group, n, c, host, P, order, d_sorted, _ = case
    ops, _, _, add = GROUPS[group][:4]
    nb, cdim = 1 << c, 64
    b = -(-n // cdim)
    slots, chunk, valid, totals = ck.bucket_scan(ops, P, order, d_sorted,
                                                 nb, cdim, True)
    assert slots.z.shape[:2] == (W, nb) and totals.z.shape[:2] == (b, W)
    want_slot = [[None] * nb for _ in range(W)]
    want_chunk = np.zeros((W, nb), dtype=np.int64)
    want_valid = np.zeros((W, nb), dtype=bool)
    want_tot = [[None] * W for _ in range(b)]
    for w in range(W):
        for k in range(b):
            acc = None
            for pos in range(k * cdim, min(n, k * cdim + cdim)):
                acc = add(acc, host[int(order[w, pos])])
                dig = int(d_sorted[w, pos])
                if pos == n - 1 or dig != int(d_sorted[w, pos + 1]):
                    want_slot[w][dig] = acc
                    want_chunk[w, dig] = k
                    want_valid[w, dig] = True
            want_tot[k][w] = acc
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(chunk.numpy(), want_chunk)
    for w in range(W):
        assert _affine(ops, jac.JPoint(*(a[w] for a in slots))) == \
            want_slot[w]
    for k in range(b):
        assert _affine(ops, jac.JPoint(*(a[k] for a in totals))) == \
            want_tot[k]


def test_edge_buckets(case):
    """Window 0: digit 0 (P, -P) is a valid bucket whose slot is the
    infinity that madd's cancel branch returns; digit 1 (three equal
    points after it) holds 3 P' through the doubling branch; the three
    excluded digits are empty."""
    group, n, c, host, P, order, d_sorted, _ = case
    ops, _, _, _, _, smul = GROUPS[group]
    nb = 1 << c
    slots, chunk, valid, _ = ck.bucket_scan(ops, P, order, d_sorted, nb,
                                            64, True)
    assert bool(valid[0, 0]) and bool(valid[0, 1])
    inf = jac.infinity(ops, ())
    for a, b in zip(slots, inf):
        assert torch.equal(a[0, 0], b)
    assert _affine(ops, jac.JPoint(*(a[0, 1:2] for a in slots))) == \
        [smul(host[EQUAL[0]], 3)]
    for dig in (3, nb // 2, nb - 2):
        assert not bool(valid[0, dig]) and int(chunk[0, dig]) == 0
        for a, b in zip(slots, inf):
            assert torch.equal(a[0, dig], b)


def test_bucket_scan_rejects_other_devices():
    ops = FQ_OPS
    meta = jac.JPoint(*(torch.empty((4, 8), dtype=torch.int32,
                                    device="meta") for _ in range(3)))
    order = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.bucket_scan(ops, meta, order, order, 16, 4, True)


@pytest.mark.parametrize("bad", [-1, 16])
def test_kernel_wrapper_rejects_out_of_range_digits(bad):
    """The kernel narrows digits to u32 and writes slot w nb + digit
    without a bound, so its wrapper refuses a digit outside [0, nb)
    before it builds or launches anything."""
    pts = jac.JPoint(*(torch.zeros((4, 8), dtype=torch.int32)
                       for _ in range(3)))
    order = torch.arange(4).repeat(2, 1)
    d_sorted = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 3]])
    d_sorted[1, 0 if bad < 0 else -1] = bad
    with pytest.raises(ValueError, match=r"digit outside \[0, 16\)"):
        ck._bucket_scan_cuda(FQ_OPS, pts, order, d_sorted, 16, 4, True)
