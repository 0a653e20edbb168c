"""The port's point kernels K2-K4 (plain versions) and batch_normalize
against the JAX package.

The plain madd / add / double (what `ops.curve_kernels` runs on a CPU
tensor) are held to the Pallas kernel cores `curve_pallas._madd_core` /
`_add_core` / `_double_core`, driven on the CPU as
tests/test_curve_pallas.py drives them: raw Jacobian coordinates must be
equal.  They are also compared in affine form with the XLA path
`jacobian._add_xla` / `_double_xla`, on G1 and G2, with every edge case
(P = Q, P = -Q, P = inf, Q = inf, an unnormalized P, a malformed Z).
Tolerance: exact equality of canonical residues.
"""

import random

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.curve import jacobian as jjac  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ2_OPS as J_FQ2  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ_OPS as J_FQ  # noqa: E402
from zksnark_tpu.field import limb as jlimb  # noqa: E402
from zksnark_tpu.ops import curve_pallas as cpal  # noqa: E402
from zksnark_tpu.ops import fieldcore as fc  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.ops import curve_kernels as ck  # noqa: E402

GROUPS = {"g1": (FQ_OPS, J_FQ), "g2": (FQ2_OPS, J_FQ2)}
Q = limb.FQ_CTX.p


def _host(group, ks):
    if group == "g1":
        return [hc.g1_scalar_mul(hc.G1_GEN_PT, k) for k in ks]
    return [hc.g2_scalar_mul(hc.G2_GEN, k) for k in ks]


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


def _scaled(ops, p, lam):
    """(l^2 X, l^3 Y, l Z): the same points with another Z."""
    lm = torch.from_numpy(ops.to_mont_np([lam] if ops.elem_ndim == 1
                                         else [[lam, 0]])[0])
    l2 = ops.mul(lm, lm)
    return jac.JPoint(ops.mul(p.x, l2), ops.mul(p.y, ops.mul(l2, lm)),
                      ops.mul(p.z, lm))


def _cat(*ps):
    return jac.JPoint(*(torch.cat(c) for c in zip(*ps)))


@pytest.fixture(scope="module", params=["g1", "g2"])
def cases(request):
    """(group, P, Q, host sums of the edge rows): Q is affine-or-inf."""
    group = request.param
    ops = GROUPS[group][0]
    rng = random.Random(2024 if group == "g1" else 2025)
    ks = [rng.randrange(1, limb.FR_CTX.p) for _ in range(14)]
    h = _host(group, ks)
    A, B = h[0], h[1]
    neg = hc.g1_neg if group == "g1" else hc.g2_neg
    P = _cat(_pts(group, h[2:6]), _scaled(ops, _pts(group, h[6:8]), 3),
             _pts(group, [A]), _scaled(ops, _pts(group, [A]), 5),
             _pts(group, [A, None, A, None]))
    Qp = _pts(group, h[8:14] + [A, A, neg(A), B, None, None])
    # a malformed Z (q: zero mod q, nonzero limbs) in the last row of P
    mal = torch.zeros_like(P.z[:1])
    mal.reshape(-1, 8)[0] = torch.from_numpy(
        np.frombuffer(Q.to_bytes(32, "little"), dtype="<i4").copy())
    P = _cat(P, jac.JPoint(P.x[:1], P.y[:1], mal))
    Qp = _cat(Qp, _pts(group, [B]))
    return group, P, Qp


def _to_jax(p: jac.JPoint):
    return jjac.JPoint(*(jnp.asarray(limb.limbs_to_jax_np(c.numpy()))
                         for c in p))


def _jax_core(jops, fn, *pts):
    """Run a Pallas kernel core on JAX JPoints via the digit-major codec
    (the pattern of tests/test_curve_pallas.py)."""
    nr = cpal._nrows(jops)
    cc = fc.make_consts(jlimb.FQ_CTX)
    K = cpal._KFq(cc) if nr == cpal.L else cpal._KFq2(cc)
    args, meta = [], None
    for p in pts:
        for arr in p:
            lm, bs, n = cpal._to_lane_major(arr, nr)
            args.append(lm.T)
            meta = (bs, n)
    bs, n = meta
    return [np.asarray(cpal._from_lane_major(o.T, nr, bs, n))
            for o in fn(K, *args)]


def _raw(p: jac.JPoint):
    return [limb.limbs_to_jax_np(c.numpy()) for c in p]


@pytest.mark.parametrize("op", ["madd", "add", "double"])
def test_plain_point_ops_equal_pallas_cores(cases, op):
    group, P, Qp = cases
    ops, jops = GROUPS[group]
    before = dict(ck.LAUNCHES)
    if op == "double":
        got = ck.double(ops, P)
        want = _jax_core(jops, cpal._double_core, _to_jax(P))
    else:
        got = getattr(ck, op)(ops, P, Qp)
        core = cpal._madd_core if op == "madd" else cpal._add_core
        want = _jax_core(jops, core, _to_jax(P), _to_jax(Qp))
    assert ck.LAUNCHES == before        # CPU tensors run the plain versions
    for g, w in zip(_raw(got), want):
        np.testing.assert_array_equal(g, w)


def test_point_ops_equal_xla_path_affine(cases):
    group, P, Qp = cases
    ops, jops = GROUPS[group]
    jp, jq = _to_jax(P), _to_jax(Qp)
    want_add = jjac.to_affine_np(jops, jjac._add_xla(jops, jp, jq)).tolist()
    # the malformed-Z row (last) is not a point: compare the others
    for got in (ck.add(ops, P, Qp), ck.madd(ops, P, Qp)):
        assert jac.to_affine_np(ops, got).tolist()[:-1] == want_add[:-1]
    want_dbl = jjac.to_affine_np(jops, jjac._double_xla(jops, jp)).tolist()
    assert jac.to_affine_np(ops, ck.double(ops, P)).tolist()[:-1] == \
        want_dbl[:-1]
    # semantics of the edge rows: 2A, 2A, A + (-A) = inf, inf + B = B,
    # A + inf = A, inf + inf = inf
    aff = jac.to_affine_np(ops, ck.madd(ops, P, Qp)).tolist()
    hadd = hc.g1_add if group == "g1" else hc.g2_add
    A = jac.to_affine_np(ops, jac.JPoint(*(c[6] for c in P)))
    B = jac.to_affine_np(ops, jac.JPoint(*(c[9] for c in Qp)))
    if group == "g2":
        aff = [None if a is None else tuple(map(tuple, a)) for a in aff]
        A, B = (tuple(map(tuple, v)) for v in (A, B))
    assert aff[6:12] == [hadd(A, A), hadd(A, A), None, B, A, None]


def test_out_argument_and_broadcast(cases):
    group, P, Qp = cases
    ops = GROUPS[group][0]
    out = jac.JPoint(*(torch.empty_like(c) for c in P))
    res = ck.add(ops, P, Qp, out=out)
    assert all(r.data_ptr() == o.data_ptr() for r, o in zip(res, out))
    for a, b in zip(res, ck.add_plain(ops, P, Qp)):
        assert torch.equal(a, b)
    one = jac.JPoint(*(c[:1] for c in Qp))           # (1,) against (n,)
    for a, b in zip(ck.madd(ops, P, one),
                    ck.madd_plain(ops, P, jac.JPoint(
                        *(c.expand_as(d) for c, d in zip(one, P))))):
        assert torch.equal(a, b)


def test_batch_normalize_matches_jax(cases):
    group, P, Qp = cases
    ops, jops = GROUPS[group]
    pts = _cat(jac.JPoint(*(c[:-1] for c in P)), Qp)   # drop the malformed
    got = jac.batch_normalize(ops, pts)
    want = jjac.batch_normalize(jops, _to_jax(pts))
    for g, w in zip(_raw(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    z = ops.from_mont_np(got.z.numpy())
    assert set(int(v) for v in np.asarray(z).reshape(-1)) <= {0, 1}


def test_batch_normalize_malformed_z_raises(cases):
    group, P, Qp = cases
    ops = GROUPS[group][0]
    with pytest.raises(ValueError, match="malformed Z"):
        jac.batch_normalize(ops, P)
