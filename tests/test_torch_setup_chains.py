"""The port's setup chains against the JAX package: batch_normalize's K1
work (the prefix-product scan `ops.montmul.mont_scan` and the pass over
the points `ops.montmul.normalize`) and setup's K2 chain (the comb
encryption `ops.curve_kernels.comb`), on CPU tensors, where each wrapper
runs its plain version.

- `curve.jacobian._prefix_prod` (the scan, one level or several) equals
  JAX `jacobian._prefix_prod` over Fq and Fq2 at n in {1, 63, 64, 65,
  4099}, with zeros and ones among the elements; a scan from carries
  equals the carry times JAX's prefix; `_prefix_prod` makes
  `scan_launches(n)` scan calls; the plain scan splits a row into the
  kernel's thread count;
- `comb` equals JAX `prover._comb_encrypt_impl` in raw Jacobian
  coordinates, with the JAX package's madd as the TPU runs it (the Pallas
  kernel's `_madd_core`, driven on the CPU through the kernel's
  lane-major codec, as tests/test_curve_pallas.py drives it), at m = 256
  (G1) and m = 64 (G2), scalars 0, 1, r - 1 and ones holding zero bytes
  among random ones; the affine results are s * base on the host curve;
- `batch_normalize` equals JAX's on G2 and at n not a multiple of 64,
  and its pass over the points (`normalize`) JAX's `_bn_apply`;
- CPU tensors launch nothing, and the wrappers reject bad shapes, other
  fields and tensors on two devices;
- `device_setup(timer=)` times its phases and gives the untimed CRS.
Inputs come from numpy seeds.  Tolerance: exact equality of canonical
residues.
"""

from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.curve import jacobian as jjac  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ2_OPS as J_FQ2  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ_OPS as J_FQ  # noqa: E402
from zksnark_tpu.field import limb as jlimb  # noqa: E402
from zksnark_tpu.groth16 import prover as jprover  # noqa: E402
from zksnark_tpu.ops import curve_pallas as cpal  # noqa: E402
from zksnark_tpu.ops import fieldcore as fc  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field import limb, params  # noqa: E402
from zksnark_tpu_torch.groth16 import prover  # noqa: E402
from zksnark_tpu_torch.ops import curve_kernels as ck  # noqa: E402
from zksnark_tpu_torch.ops import montmul as mm  # noqa: E402

FIELDS = {"fq": (FQ_OPS, J_FQ), "fq2": (FQ2_OPS, J_FQ2)}
GROUPS = {"g1": (FQ_OPS, J_FQ), "g2": (FQ2_OPS, J_FQ2)}
Q = limb.FQ_CTX.p
R = limb.FR_CTX.p
torch.set_num_threads(1)     # small tensors: threads only add overhead


def _elems(ops, rng, n, special=True):
    """n random Fq (Fq2) Montgomery residues as (n, *elem) limbs; with
    `special`, zeros and ones among them (every 7th and 11th element)."""
    e = ops.elem_ndim
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=n * e * 5)]
    ints = [(vals[5 * i] << 192 ^ vals[5 * i + 1] << 128
             ^ vals[5 * i + 2] << 64 ^ vals[5 * i + 3]) % Q
            for i in range(n * e)]
    if special:
        for i in range(0, n * e, 7):
            ints[i] = 0
        for i in range(3, n * e, 11):
            ints[i] = 1
    arr = limb.FQ_CTX.to_mont_np(ints)
    return torch.from_numpy(arr.reshape((n,) + ((8,) if e == 1 else (2, 8))))


def _to_jax(t):
    return jnp.asarray(limb.limbs_to_jax_np(t.numpy()))


def _assert_raw_equal(port, jax_arr):
    np.testing.assert_array_equal(limb.limbs_to_jax_np(port.numpy()),
                                  np.asarray(jax_arr).astype(np.float32))


# ---------------------------------------------------------------------------
# the prefix-product scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["fq", "fq2"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 4099])
def test_prefix_prod_equals_jax(field, n):
    ops, jops = FIELDS[field]
    x = _elems(ops, np.random.default_rng(n * 10 + len(field)), n)
    before = dict(mm.LAUNCHES)
    got = jac._prefix_prod(ops, x)
    assert mm.LAUNCHES == before        # CPU tensors run the plain version
    # jitted, as JAX's _bn_scan runs it: one XLA compile for all levels
    want = jax.jit(partial(jjac._prefix_prod, jops))(_to_jax(x))
    _assert_raw_equal(got, want)


@pytest.mark.parametrize("field", ["fq", "fq2"])
def test_scan_from_carries_equals_jax(field):
    """Rows of a (5, 9) grid, each from its own carry, with and without
    every prefix: carry times JAX's prefix of the row."""
    ops, jops = FIELDS[field]
    rng = np.random.default_rng(7 + len(field))
    grid = _elems(ops, rng, 45).reshape((5, 9) + ops.zero().shape)
    carry = _elems(ops, rng, 5, special=False)
    totals, within = mm.mont_scan(ops, grid, carry)
    totals_only, none = mm.mont_scan(ops, grid, carry, collect=False)
    assert none is None and torch.equal(totals, totals_only)
    # JAX's prefix of [carry, row...] per row, all rows in one program
    rows = torch.cat([carry.unsqueeze(1), grid], dim=1)
    want = jax.vmap(partial(jjac._prefix_prod, jops))(_to_jax(rows))
    _assert_raw_equal(within, want[:, 1:])
    _assert_raw_equal(totals, want[:, -1])


@pytest.mark.parametrize("n", [1, 64, 2048, 2049, 4099, 70000])
def test_prefix_prod_makes_scan_launches(monkeypatch, n):
    """`_prefix_prod` scans `scan_launches(n)` times (what chip_smoke.py
    expects of each batch_normalize on the card)."""
    calls = []
    real = mm.mont_scan

    def counting(*args, **kw):
        calls.append(args[1].shape[:2])
        return real(*args, **kw)

    monkeypatch.setattr(mm, "mont_scan", counting)
    x = FQ_OPS.one((n,)).contiguous()
    out = jac._prefix_prod(FQ_OPS, x)
    assert torch.equal(out, x)          # prefix products of ones
    assert len(calls) == jac.scan_launches(n)
    assert calls[0][1] == mm.scan_chunk(n)


def test_scan_split_matches_the_kernel():
    """The plain scan splits a row as the kernel does: `SCAN_THREADS` is
    the block size of csrc/mont_scan.cu."""
    import os
    import re

    from zksnark_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "mont_scan.cu")) as f:
        threads = re.findall(r"constexpr int kThreads = (\d+);", f.read())
    assert threads == [str(mm.SCAN_THREADS)]
    assert mm.SCAN_ROW % mm.SCAN_THREADS == 0


# ---------------------------------------------------------------------------
# the comb encryption
# ---------------------------------------------------------------------------

def _pallas_madd(jops, p, q):
    """JAX `jacobian.madd` as the TPU runs it: the Pallas kernel's
    `_madd_core` on the lane-major codec (traceable, so it runs inside
    `_comb_encrypt_impl`'s lax.scan)."""
    nr = cpal._nrows(jops)
    cc = fc.make_consts(jlimb.FQ_CTX)
    K = cpal._KFq(cc) if nr == cpal.L else cpal._KFq2(cc)
    args, meta = [], None
    for pt in (p, q):
        for arr in pt:
            lm, bs, n = cpal._to_lane_major(arr, nr)
            args.append(lm.T)
            meta = (bs, n)
    bs, n = meta
    return jjac.JPoint(*(cpal._from_lane_major(o.T, nr, bs, n)
                         for o in cpal._madd_core(K, *args)))


def _scalars(rng, m):
    """m scalars: 0, 1, r - 1, ones holding zero bytes, then random."""
    fixed = [0, 1, R - 1, 1 << 200, (1 << 64) + 255, 0xFF00FF00 << 96,
             sum(0xAB << (16 * i) for i in range(16)) % R]
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=4 * m)]
    rand = [(vals[4 * i] << 192 ^ vals[4 * i + 1] << 128
             ^ vals[4 * i + 2] << 64 ^ vals[4 * i + 3]) % R
            for i in range(m - len(fixed))]
    return fixed + rand


@pytest.fixture(scope="module", params=[("g1", 256), ("g2", 64)])
def comb_case(request):
    group, m = request.param
    ops, jops = GROUPS[group]
    if group == "g1":
        base = hc.g1_scalar_mul(hc.G1_GEN_PT, params.ENCRYPT_G1_SCALE)
    else:
        base = hc.g2_scalar_mul(hc.G2_GEN, params.ENCRYPT_G2_SCALE)
    table = prover._comb_table(ops, base, "cpu")
    ints = _scalars(np.random.default_rng(m), m)
    scalars = torch.from_numpy(limb.FR_CTX.to_limbs_np(ints))
    return group, ops, jops, base, table, ints, scalars


def test_comb_equals_jax_comb_encrypt(comb_case, monkeypatch):
    group, ops, jops, _, table, _, scalars = comb_case
    before = dict(ck.LAUNCHES)
    got = ck.comb(ops, table, scalars)
    assert ck.LAUNCHES == before        # CPU tensors run the plain version
    monkeypatch.setattr(jjac, "madd", _pallas_madd)
    jtable = jjac.JPoint(*(_to_jax(a) for a in table))
    want = jax.jit(partial(jprover._comb_encrypt_impl, jops))(
        jtable, _to_jax(scalars))
    for g, w in zip(got, want):
        _assert_raw_equal(g, w)


def test_comb_is_scalar_times_base(comb_case):
    group, ops, _, base, table, ints, scalars = comb_case
    idx = list(range(8)) + [len(ints) - 1]
    got = jac.to_affine_np(ops, ck.comb(ops, table, scalars[idx]))
    smul = hc.g1_scalar_mul if group == "g1" else hc.g2_scalar_mul
    for g, i in zip(got, idx):
        if group == "g2" and g is not None:
            g = tuple(map(tuple, g))
        assert g == (smul(base, ints[i]) if ints[i] else None)


# ---------------------------------------------------------------------------
# batch_normalize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,n", [("g1", 65), ("g2", 70)])
def test_batch_normalize_equals_jax(group, n):
    """Random Jacobian coordinates (batch_normalize is field arithmetic
    alone), every 9th point at infinity; and its pass over the points
    (`normalize`) against JAX's `_bn_apply` on random products."""
    ops, jops = GROUPS[group]
    rng = np.random.default_rng(n)
    x, y = _elems(ops, rng, n, False), _elems(ops, rng, n, False)
    z = _elems(ops, rng, n, False)
    z[::9] = 0
    pts = jac.JPoint(x, y, z)
    before = (dict(mm.LAUNCHES), dict(ck.LAUNCHES))
    got = jac.batch_normalize(ops, pts)
    assert (dict(mm.LAUNCHES), dict(ck.LAUNCHES)) == before
    want = jjac.batch_normalize(jops, jjac.JPoint(*(_to_jax(a) for a in pts)))
    for g, w in zip(got, want):
        _assert_raw_equal(g, w)
    # the pass over the points alone, from unrelated products: JAX's
    # _bn_apply (compiled above for these shapes)
    pre, suf = _elems(ops, rng, n), _elems(ops, rng, n)
    tinv = _elems(ops, rng, 1, False)[0]
    got = mm.normalize(ops, x, y, z, pre, suf, tinv)
    want = jjac._bn_apply(jops, _to_jax(x), _to_jax(y),
                          jnp.asarray(ops.is_zero(z).numpy()), _to_jax(pre),
                          _to_jax(suf), _to_jax(tinv))
    for g, w in zip(got, want):
        _assert_raw_equal(g, w)


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def test_mont_scan_rejects_bad_input():
    grid = FQ_OPS.one((3, 4)).contiguous()
    with pytest.raises(ValueError, match="grid"):
        mm.mont_scan(FQ_OPS, grid[..., :4])                 # not 8 limbs
    with pytest.raises(ValueError, match="grid"):
        mm.mont_scan(FQ2_OPS, grid)                          # not Fq2
    with pytest.raises(ValueError, match="grid"):
        mm.mont_scan(FQ_OPS, grid.to(torch.int64))
    with pytest.raises(ValueError, match="Fq and Fq2 only"):
        mm.mont_scan(type(FQ_OPS)(limb.FR_CTX), grid)
    with pytest.raises(ValueError, match="rows"):
        mm.mont_scan(FQ_OPS, grid, FQ_OPS.one((4,)).contiguous())
    with pytest.raises(ValueError, match="carry on meta"):
        mm.mont_scan(FQ_OPS, grid, torch.empty((3, 8), dtype=torch.int32,
                                               device="meta"))


def test_normalize_rejects_bad_input():
    rng = np.random.default_rng(5)
    pts = [_elems(FQ_OPS, rng, 6, False) for _ in range(5)]
    tinv = pts[0][0]
    mm.normalize(FQ_OPS, *pts, tinv)                          # accepted
    with pytest.raises(ValueError, match="points and products"):
        mm.normalize(FQ_OPS, *pts[:4], pts[4][:5], tinv)
    with pytest.raises(ValueError, match="points and products"):
        mm.normalize(FQ_OPS, *pts, pts[0][:2])
    with pytest.raises(ValueError, match="points and products"):
        mm.normalize(FQ2_OPS, *pts, tinv)
    with pytest.raises(ValueError, match="Fq and Fq2 only"):
        mm.normalize(type(FQ_OPS)(limb.FR_CTX), *pts, tinv)
    with pytest.raises(ValueError, match="one device"):
        mm.normalize(FQ_OPS, *pts[:4], pts[4].to("meta"), tinv)


def test_comb_rejects_bad_input(comb_case):
    group, ops, _, _, table, _, scalars = comb_case
    other = FQ2_OPS if group == "g1" else FQ_OPS
    with pytest.raises(ValueError, match="table"):
        ck.comb(other, table, scalars)                       # wrong group
    with pytest.raises(ValueError, match="table"):
        ck.comb(ops, jac.JPoint(*(a[:31] for a in table)), scalars)
    with pytest.raises(ValueError, match="scalars"):
        ck.comb(ops, table, scalars[:, :4])
    with pytest.raises(ValueError, match="scalars"):
        ck.comb(ops, table, scalars.to(torch.int64))
    with pytest.raises(ValueError, match="scalars on meta"):
        ck.comb(ops, table, torch.empty((4, 8), dtype=torch.int32,
                                        device="meta"))


# ---------------------------------------------------------------------------
# the setup's phases
# ---------------------------------------------------------------------------

def test_device_setup_timer_phases():
    from zksnark_tpu_torch.bench import synthetic_square_chain
    from zksnark_tpu_torch.utils.profiling import PhaseTimer

    r1cs, _ = synthetic_square_chain(7)
    dq = prover.compile_r1cs(r1cs, device="cpu")
    t = PhaseTimer()
    timed = prover.device_setup(dq, trapdoor=(11, 22, 33, 44, 55), timer=t)
    plain = prover.device_setup(dq, trapdoor=(11, 22, 33, 44, 55))
    assert set(t.phases) == {"scalars", "sigma (host)", "comb", "normalize",
                             "tables"}
    assert all(v >= 0 for v in t.phases.values())
    for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2"):
        for a, b in zip(getattr(timed, name), getattr(plain, name)):
            assert torch.equal(a, b), name
    assert timed.sigmag1 == plain.sigmag1 and timed.sigmag2 == plain.sigmag2
