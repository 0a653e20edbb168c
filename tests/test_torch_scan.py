"""The port's point chains (`add_scan`, `double_n`, `horner` in
`zksnark_tpu_torch.ops.curve_kernels`) against the JAX package, on G1 and
G2.

On CPU tensors the wrappers run their plain versions, the loops of the
plain point operations; those must equal, in raw Jacobian coordinates,
- `zksnark_tpu.ops.msm._scan_chunks` with the add combine (collect on and
  off; every prefix and the totals),
- `zksnark_tpu.ops.msm._double_n`,
- a JAX Horner over `jacobian.double` / `jacobian.add` in the order of
  `_msm_impl`'s `horner_body`.
The inputs are host-curve points with other Z representatives and the
chains' edge cases: a step at infinity, a step equal to the accumulator
(the doubling branch), a step equal to its negation (the cancel branch),
a lane that is all infinity, k = 0 and k = 1, window sums at infinity.
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
from zksnark_tpu_torch.ops import curve_kernels as ck  # noqa: E402

GROUPS = {"g1": (FQ_OPS, J_FQ), "g2": (FQ2_OPS, J_FQ2)}
torch.set_num_threads(1)     # small tensors: threads only add overhead


def _pts(group, host):
    """Host affine points (None = inf) -> port JPoint, Z in {0, one}."""
    ops = GROUPS[group][0]
    g1 = group == "g1"
    zero = 0 if g1 else [0, 0]
    x = [zero if h is None else (h[0] if g1 else list(h[0])) for h in host]
    y = [zero if h is None else (h[1] if g1 else list(h[1])) for h in host]
    inf = torch.tensor([h is None for h in host])
    z = ops.select(inf, ops.zero((len(host),)), ops.one((len(host),)))
    return jac.JPoint(torch.from_numpy(ops.to_mont_np(x)),
                      torch.from_numpy(ops.to_mont_np(y)), z)


def _rescale(ops, p, lams):
    """(l^2 X, l^3 Y, l Z) row by row: the same points, other Z."""
    lm = torch.from_numpy(ops.to_mont_np(
        lams if ops.elem_ndim == 1 else [[v, 0] for v in lams]))
    l2 = ops.mul(lm, lm)
    return jac.JPoint(ops.mul(p.x, l2), ops.mul(p.y, ops.mul(l2, lm)),
                      ops.mul(p.z, lm))


@pytest.fixture(scope="module", params=["g1", "g2"])
def points(request):
    """(group, 24 points): a (3, 4, 2) grid of chunks x steps x lanes,
    flattened chunk-major.  Lane (chunk 0, 0) adds A to A (doubling);
    (1, 0) adds C to -C (cancel); (2, 1) is all infinity; infinities and
    rescaled Z elsewhere."""
    group = request.param
    ops = GROUPS[group][0]
    rng = random.Random(77 if group == "g1" else 78)
    smul = hc.g1_scalar_mul if group == "g1" else hc.g2_scalar_mul
    neg = hc.g1_neg if group == "g1" else hc.g2_neg
    gen = hc.G1_GEN_PT if group == "g1" else hc.G2_GEN
    A, B, C, D, E, F = (smul(gen, rng.randrange(1, limb.FR_CTX.p))
                        for _ in range(6))
    # grid[chunk][step][lane]
    grid = [[[A, B], [A, None], [B, C], [None, D]],
            [[C, D], [neg(C), E], [D, None], [E, F]],
            [[F, None], [None, None], [A, None], [B, None]]]
    host = [p for chunk in grid for step in chunk for p in step]
    lams = [rng.randrange(2, 1000) for _ in host]
    return group, _rescale(ops, _pts(group, host), lams)


def _to_jax(p):
    return jjac.JPoint(*(jnp.asarray(limb.limbs_to_jax_np(c.numpy()))
                         for c in p))


def _assert_raw_equal(port, jax_pt):
    for c, j in zip(port, jax_pt):
        np.testing.assert_array_equal(limb.limbs_to_jax_np(c.numpy()),
                                      np.asarray(j))


def _grid(p, shape):
    return jac.JPoint(*(c.reshape(shape + c.shape[1:]) for c in p))


def _jax_scan(jops, flat, collect):
    """JAX `_scan_chunks` (c = 4) over axis 0 of (12, 2) points, mapped
    over the lane axis as the JAX MSM maps it over windows: totals
    (3, 2), within (3, 2, 4)."""
    return jax.vmap(lambda p: jmsm._scan_chunks(
        jops, p, partial(jjac.add, jops), 4, collect), in_axes=(1,),
        out_axes=1)(_to_jax(flat))


def test_add_scan_equals_jax_scan_chunks(points):
    group, P = points
    ops, jops = GROUPS[group]
    flat = jac.JPoint(*(c.reshape((12, 2) + c.shape[1:]) for c in P))
    grid = _grid(P, (3, 4, 2))
    before = dict(ck.LAUNCHES)
    totals, within = ck.add_scan(ops, grid, collect=True)
    totals_only, none = ck.add_scan(ops, grid, collect=False)
    assert ck.LAUNCHES == before       # CPU tensors run the plain version
    assert none is None
    want_t, want_w = _jax_scan(jops, flat, True)
    _assert_raw_equal(jac.JPoint(*(c.transpose(1, 2) for c in within)),
                      want_w)
    _assert_raw_equal(totals, want_t)
    _assert_raw_equal(totals_only, want_t)
    # the edge lanes mean what they should
    assert jac.to_affine_np(ops, jac.JPoint(*(c[1, 1, 0] for c in within))) \
        is None                                              # C + (-C)
    assert jac.to_affine_np(ops, jac.JPoint(*(c[2, 1] for c in totals))) \
        is None                                              # all infinity


def test_add_scan_collect_off_equals_jax(points):
    """The JAX scan without collecting (a separately traced program) gives
    the same totals as the port's collect=False."""
    group, P = points
    ops, jops = GROUPS[group]
    flat = jac.JPoint(*(c.reshape((12, 2) + c.shape[1:]) for c in P))
    got, _ = ck.add_scan(ops, _grid(P, (3, 4, 2)), collect=False)
    want, none = _jax_scan(jops, flat, False)
    assert none is None
    _assert_raw_equal(got, want)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_double_n_equals_jax(points, k):
    group, P = points
    ops, jops = GROUPS[group]
    p = jac.JPoint(*(c[:6] for c in P))                 # includes infinity
    before = dict(ck.LAUNCHES)
    got = ck.double_n(ops, p, k)
    assert ck.LAUNCHES == before
    _assert_raw_equal(got, jmsm._double_n(jops, _to_jax(p), k))


def _jax_horner(jops, sums, c):
    """`_msm_impl`'s horner_body over (W, ...) window sums."""
    n_win = sums.z.shape[0]
    batch = sums.z.shape[1:sums.z.ndim - jops.elem_ndim]

    def horner_body(acc, w):
        acc = jmsm._double_n(jops, acc, c)
        wp = jjac.JPoint(sums.x[n_win - 1 - w], sums.y[n_win - 1 - w],
                         sums.z[n_win - 1 - w])
        return jjac.add(jops, acc, wp), None

    acc, _ = jax.lax.scan(horner_body, jjac.infinity(jops, batch),
                          jnp.arange(n_win))
    return acc


def test_horner_equals_jax(points):
    """Three windows of two MSMs, c = 2, with a window sum at infinity
    (window 1 of the second MSM)."""
    group, P = points
    ops, jops = GROUPS[group]
    sums = jac.JPoint(*(c[:6].reshape((3, 2) + c.shape[1:]) for c in P))
    before = dict(ck.LAUNCHES)
    got = ck.horner(ops, sums, 2)
    assert ck.LAUNCHES == before
    _assert_raw_equal(got, _jax_horner(jops, _to_jax(sums), 2))
    # and the plain loops as the MSM ran them before: 2^c acc by c
    # elementwise doublings, then one add
    acc = jac.infinity(ops, (2,))
    for w in (2, 1, 0):
        for _ in range(2):
            acc = ck.double(ops, acc)
        acc = ck.add(ops, acc, jac.JPoint(*(c[w] for c in sums)))
    for a, b in zip(got, acc):
        assert torch.equal(a, b)


def test_chains_reject_other_devices(points):
    group, P = points
    ops = GROUPS[group][0]
    meta = jac.JPoint(*(torch.empty(c.shape, dtype=c.dtype, device="meta")
                        for c in P))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.double_n(ops, meta, 1)
    with pytest.raises(ValueError, match="k = -1"):
        ck.double_n(ops, P, -1)
