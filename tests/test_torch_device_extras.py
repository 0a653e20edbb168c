"""The port's device extras against the JAX package, on the CPU (every
kernel replaced by its plain version).

- `field.limb` / `ops.montmul` `mont_sqr`, `eq`, `mont_pow_fixed` and
  `mont_inv` against JAX `field/limb.py`, Fr and Fq, zero included;
- `ops.ntt.poly_mul` against JAX `ntt.poly_mul` and the host `dense.mul`
  at log n <= 8;
- `ops.msm.msm(..., scalar_bits=64)` (64 points, c = 4: W = 16 windows
  where the unbounded MSM has 64) against JAX `msm(..., scalar_bits=64)`
  and against the unbounded MSM, in affine form (the port's tail
  associates its adds otherwise, so its Jacobian coordinates differ);
- `ops.msm.msm_windowed_batch` against JAX `_msm_windowed_many`, as
  tests/test_msm_kernels.py sets it up, in affine form;
- `curve.jacobian.is_infinity`;
- `utils.profiling`'s work counts against JAX's, the port's own
  `limb_muls` unit, and `PhaseTimer`;
- the bench's `synthetic_square_chain` and `_reference_model_ms` against
  root `bench.py`'s at 2^4, and `python -m zksnark_tpu_torch.bench
  --device cpu --log-n 3 --repeats 1`.
Tolerance: exact equality (limbs compared as JAX digits, points in
affine form).
"""

import functools
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.curve import jacobian as jjac  # noqa: E402
from zksnark_tpu.curve.field_ops import FQ_OPS as J_FQ  # noqa: E402
from zksnark_tpu.field import limb as jlimb  # noqa: E402
from zksnark_tpu.ops import msm as jmsm  # noqa: E402
from zksnark_tpu.ops import ntt as jntt  # noqa: E402
from zksnark_tpu.utils import profiling as jprof  # noqa: E402
from zksnark_tpu_torch import bench  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.field.host import FR  # noqa: E402
from zksnark_tpu_torch.field.params import R  # noqa: E402
from zksnark_tpu_torch.ops import montmul as mm  # noqa: E402
from zksnark_tpu_torch.ops import msm  # noqa: E402
from zksnark_tpu_torch.ops import ntt  # noqa: E402
from zksnark_tpu_torch.poly import dense  # noqa: E402
from zksnark_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CTXS = {"Fr": (limb.FR_CTX, jlimb.FR_CTX), "Fq": (limb.FQ_CTX, jlimb.FQ_CTX)}
torch.set_num_threads(1)     # small tensors: threads only add overhead


def _rand(seed, p, n):
    """n field elements from a numpy seed (python ints)."""
    raw = np.random.default_rng(seed).integers(
        0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a << 252 ^ b << 189 ^ c << 126 ^ d << 63 ^ e) % p
            for a, b, c, d, e in raw]


def _both(ctx, vals):
    m = ctx.to_mont_np(vals)
    return torch.from_numpy(m), jnp.asarray(limb.limbs_to_jax_np(m))


def _eq(port, jax_arr):
    np.testing.assert_array_equal(limb.limbs_to_jax_np(port.numpy()),
                                  np.asarray(jax_arr))


# ---------------------------------------------------------------------------
# the field ladders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ladders(field):
    jctx = CTXS[field][1]
    return (jax.jit(functools.partial(jlimb.mont_inv, jctx)),
            jax.jit(functools.partial(jlimb.mont_pow_fixed, jctx)),
            jax.jit(functools.partial(jlimb.mont_sqr, jctx)))


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_mont_inv_matches_jax_and_host(field):
    ctx, jctx = CTXS[field]
    p = ctx.p
    vals = [0, 1, p - 1, 2, (p - 1) // 2] + _rand(11, p, 11)
    x, jx = _both(ctx, vals)
    inv, _, _ = _jax_ladders(field)
    jout = inv(jx)
    assert ctx.p_minus_2_bits == tuple(
        int(b) for b in np.asarray(jctx.p_minus_2_bits))
    got = mm.mont_inv(ctx, x)
    assert torch.equal(got, limb.mont_inv(ctx, x))
    _eq(got, jout)
    host = [int(v) for v in ctx.from_mont_np(got.numpy())]
    assert host == [pow(v, p - 2, p) for v in vals]
    assert host[0] == 0                          # zero maps to zero
    assert all(h * v % p == 1 for h, v in zip(host[1:], vals[1:]))


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_mont_pow_sqr_eq_match_jax(field):
    ctx, jctx = CTXS[field]
    p = ctx.p
    vals = [0, 1, p - 1] + _rand(12, p, 9)
    x, jx = _both(ctx, vals)
    _, pow_fixed, sqr = _jax_ladders(field)
    for e in (0, 1, 2, 5, 0b1011001110001, (1 << 40) + 12345):
        bits = [int(b) for b in bin(e)[2:]] if e else []
        jbits = jnp.asarray(np.array(bits, dtype=np.uint32))
        got = mm.mont_pow_fixed(ctx, x, bits)
        assert torch.equal(got, limb.mont_pow_fixed(ctx, x, bits))
        _eq(got, pow_fixed(jx, jbits))
        assert [int(v) for v in ctx.from_mont_np(got.numpy())] == \
            [pow(v, e, p) for v in vals]
    got = mm.mont_sqr(ctx, x)
    assert torch.equal(got, limb.mont_sqr(ctx, x))
    _eq(got, sqr(jx))
    # the Montgomery one and eq
    _eq(ctx.one_mont((3,)), jctx.one_mont((3,)))
    y = x.clone()
    y[4, 0] ^= 1
    e_mine = limb.eq(x, y).numpy()
    e_jax = np.asarray(jlimb.eq(jx, jnp.asarray(
        limb.limbs_to_jax_np(y.numpy()))))
    np.testing.assert_array_equal(e_mine, e_jax)
    assert e_mine.sum() == len(vals) - 1 and not e_mine[4]


# ---------------------------------------------------------------------------
# poly_mul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_n", [1, 3, 5, 8])
def test_poly_mul_matches_jax_and_dense(log_n):
    n = 1 << log_n
    ctx = limb.FR_CTX
    rng = np.random.default_rng(log_n)
    # degrees summing to n - 1, the most the domain holds
    da = int(rng.integers(0, n))
    db = n - 1 - da
    a = _rand(100 + log_n, R, da + 1) + [0] * (n - da - 1)
    b = _rand(200 + log_n, R, db + 1) + [0] * (n - db - 1)
    (x, jx), (y, jy) = _both(ctx, a), _both(ctx, b)
    d = ntt.get_domain(log_n, "cpu")
    got = ntt.poly_mul(d, x, y)
    _eq(got, jntt.poly_mul(jntt.get_domain(log_n), jx, jy))
    want = dense.mul(FR, a, b)
    host = [int(v) for v in ctx.from_mont_np(got.numpy())]
    assert host == want + [0] * (n - len(want))


# ---------------------------------------------------------------------------
# the bounded MSM and the batch of MSMs
# ---------------------------------------------------------------------------

_G1_POW2 = []                # 2^i G, built on first use


def _g1_mul(k):
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
    return jac.from_affine(
        FQ_OPS, torch.from_numpy(FQ_OPS.to_mont_np([p[0] for p in host])),
        torch.from_numpy(FQ_OPS.to_mont_np([p[1] for p in host])))


def _to_jax(p):
    return jjac.JPoint(*(jnp.asarray(limb.limbs_to_jax_np(c.numpy()))
                         for c in p))


def _assert_group_equal(port, jax_pt):
    """The same point in affine form (None: infinity)."""
    assert jac.to_affine_np(FQ_OPS, port) == jac.to_affine_np(
        FQ_OPS, jac.JPoint(*(torch.from_numpy(limb.limbs_from_jax_np(
            np.asarray(c))) for c in jax_pt)))


def test_bounded_msm_matches_jax_and_full():
    n = 64
    rng = np.random.default_rng(64)
    ks = [int(v) % R or 1 for v in rng.integers(1, 1 << 62, size=n)]
    P = _g1(ks)
    svals = [int(v) for v in rng.integers(0, 1 << 63, size=n, dtype=np.int64)]
    svals = [(v << 1) | (i & 1) for i, v in enumerate(svals)]   # 64 bits
    svals[3], svals[9] = 0, (1 << 64) - 1
    s = torch.from_numpy(limb.FR_CTX.to_limbs_np(svals))
    want = jmsm.msm(J_FQ, _to_jax(P), jnp.asarray(
        jlimb.FR_CTX.to_limbs_np(svals)), window_bits=4, scalar_bits=64)
    assert msm._digit_columns(s, 4, 64).shape == (16, n)
    assert msm._digit_columns(s, 4).shape == (64, n)
    got = msm.msm(FQ_OPS, P, s, window_bits=4, scalar_bits=64)
    _assert_group_equal(got, want)
    full = msm.msm(FQ_OPS, P, s, window_bits=4)
    expect = _g1_mul(sum(k * v for k, v in zip(ks, svals)))
    assert jac.to_affine_np(FQ_OPS, got) == \
        jac.to_affine_np(FQ_OPS, full) == expect


def test_msm_windowed_batch_matches_jax_many():
    m, n = 3, 16
    rng = np.random.default_rng(316)
    sets, expect = [], []
    for _ in range(m):
        ks = [int(v) for v in rng.integers(1, 1 << 62, size=n)]
        svals = _rand(int(rng.integers(1 << 30)), R, n)
        sets.append((_g1(ks), torch.from_numpy(
            limb.FR_CTX.to_limbs_np(svals))))
        expect.append(_g1_mul(sum(k * v for k, v in zip(ks, svals))))
    pts = jjac.JPoint(*(jnp.stack([_to_jax(p)[k] for p, _ in sets])
                        for k in range(3)))
    scs = jnp.stack([jnp.asarray(limb.limbs_to_jax_np(s.numpy()))
                     for _, s in sets])
    # dispatched first: the JAX package computes while the port does
    out = jmsm._msm_windowed_many(J_FQ, pts, scs, 8, 0, False)
    got = msm.msm_windowed_batch(FQ_OPS, sets, 8)
    for j in range(m):
        _assert_group_equal(got[j], jjac.JPoint(out.x[j], out.y[j], out.z[j]))
        assert jac.to_affine_np(FQ_OPS, got[j]) == expect[j]


def test_is_infinity():
    P = _g1([5, 7])
    inf = jac.infinity(FQ_OPS, (1,))
    both = jac.JPoint(*(torch.cat([a, b]) for a, b in zip(P, inf)))
    got = jac.is_infinity(FQ_OPS, both)
    want = jjac.is_infinity(J_FQ, _to_jax(both))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [False, False, True]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c", [(1 << 10, 7), (1 << 20, 16), (64, 4)])
def test_work_counts_match_jax(n, c):
    # the port counts 32-bit multiply-adds, 264 per Montgomery product;
    # the JAX package 8-bit digit multiply-adds, 3 x 32 x 32 per product
    assert profiling.MULADDS_PER_MONT_MUL == 264
    nm, nt = profiling.ntt_work(n), jprof.ntt_work(n)
    assert nm["butterflies"] == nt["butterflies"]
    assert nm["limb_muls"] == nm["butterflies"] * 264
    assert nt["limb_muls"] == nt["butterflies"] * 3 * 32 * 32
    # a transform of n / 2^c points: the same butterflies on both sides
    small = max(2, n >> c)
    assert (profiling.ntt_work(small)["butterflies"]
            == jprof.ntt_work(small)["butterflies"])


def test_phase_timer():
    t = profiling.PhaseTimer()
    with t.phase("a", block_on=torch.zeros(3)):
        pass
    with t.phase("a", block_on=(torch.zeros(1), [torch.ones(1)])):
        pass
    with pytest.raises(ValueError), t.phase("b"):
        raise ValueError("the phase still counts")
    assert set(t.phases) == {"a", "b"} and t.phases["a"] >= 0
    rep = json.loads(t.report())
    assert set(rep) == {"phases_s"} and set(rep["phases_s"]) == {"a", "b"}


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------

def _root_bench():
    """Root bench.py as a module; it installs a SIGTERM handler at import,
    which is put back."""
    saved = signal.getsignal(signal.SIGTERM)
    try:
        spec = importlib.util.spec_from_file_location(
            "_root_bench", ROOT / "bench.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        signal.signal(signal.SIGTERM, saved)
    return mod


def test_bench_circuit_and_model_match_root_bench():
    rb = _root_bench()
    n_gates = (1 << 4) - 1
    r1cs, wit = bench.synthetic_square_chain(n_gates)
    jr1cs, jwit = rb.synthetic_square_chain(n_gates)
    assert wit == jwit
    assert (r1cs.u, r1cs.v, r1cs.w, r1cs.roots, r1cs.input) == \
        (jr1cs.u, jr1cs.v, jr1cs.w, jr1cs.roots, jr1cs.input)
    assert r1cs.check_satisfied(wit, R) == []
    for g, w in ((n_gates, n_gates + 2), ((1 << 20) - 1, (1 << 20) + 1)):
        assert bench._reference_model_ms(g, w) == rb._reference_model_ms(g, w)


def test_bench_cli_on_cpu(tmp_path):
    details = tmp_path / "details.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run(
        [sys.executable, "-m", "zksnark_tpu_torch.bench", "--device", "cpu",
         "--log-n", "3", "--repeats", "1", "--details", str(details)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    head = json.loads(out.stdout.strip().splitlines()[-1])
    assert head["metric"] == "groth16_prove_2^3" and head["unit"] == "ms"
    assert head["value"] > 0 and head["vs_baseline"] > 0
    d = json.loads(details.read_text())
    assert d["proof_verified"] is True
    assert d["prove_ms"] == head["value"]
    for k in ("setup_s", "prove_warmup_s", "verify_ms", "msm_g1_ms",
              "msm_gexp_per_s", "ntt_ms", "ntt_butterflies_per_s"):
        assert d[k] > 0, k
    assert d["montmul_Mmul_per_s"] is None       # CUDA events: card only
    assert "mfu_vs_mxu_bf16" not in d


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--log-n", "3"])
