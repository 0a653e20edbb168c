"""The port's host tier against the JAX package's, on the CPU.

- `poly.dense` on the goldens of tests/test_poly_dense.py and on random
  polynomials, with the division edge cases (zero divisor, divisor of
  higher degree, the dropped remainder);
- `field.host`'s `ext_euc_alg`, `chinese_remainder`, `random_elem`,
  `powers`, `dft` and `idft`;
- `groth16.qap.from_r1cs` on every `test_programs/*.zk` in Fr and Z251,
  and `R1CS.dense_point_matrices` / `coo`;
- host `protocol.setup` / `prove` with the Z251 and BN254 backends on
  simple.zk and lispesque_quad.zk, pinned and from `random.Random(seed)`:
  the same `crs_to_json` / `proof_to_json` text as the JAX package's,
  each codec reading the other's text;
- the Z251 accept / reject cases of tests/test_groth16_z251.py (CRS
  introspection, soundness statistics, hand and compiled QAPs), each
  proof also equal to the JAX package's from the same seed.
Tolerance: exact equality (every value is an integer or a string).
"""

import pathlib
import random

import numpy as np
import pytest

from zksnark_tpu.field import host as jhost
from zksnark_tpu.frontend import compiler as jcompiler
from zksnark_tpu.frontend import legacy as jlegacy
from zksnark_tpu.frontend import witness as jwitness
from zksnark_tpu.groth16 import backend as jbackend
from zksnark_tpu.groth16 import protocol as jprotocol
from zksnark_tpu.groth16 import qap as jqap
from zksnark_tpu.poly import dense as jdense
from zksnark_tpu.utils import serialization as jser
from zksnark_tpu_torch.field import host
from zksnark_tpu_torch.field.host import FR, Z251
from zksnark_tpu_torch.frontend import compiler, legacy, witness
from zksnark_tpu_torch.frontend.r1cs import R1CS
from zksnark_tpu_torch.groth16 import protocol
from zksnark_tpu_torch.groth16.backend import BN254Backend, Z251Backend
from zksnark_tpu_torch.groth16.qap import QAP, from_r1cs
from zksnark_tpu_torch.poly import dense
from zksnark_tpu_torch.utils import serialization as ser

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAMS = sorted((ROOT / "test_programs").glob("*.zk"))
LEGACY = ("quad_share.zk", "cubic_share.zk")
FIELDS = {"fr": (FR, jhost.FR), "z251": (Z251, jhost.Z251)}
BE = Z251Backend()


def _parse(path, fname):
    mine_f, jax_f = FIELDS[fname]
    code = path.read_text()
    mod, jmod = ((legacy, jlegacy) if path.name in LEGACY
                 else (compiler, jcompiler))
    return mod.parse(code, mine_f), jmod.parse(code, jax_f)


# ---------------------------------------------------------------------------
# poly.dense
# ---------------------------------------------------------------------------

# (function, arguments, golden) from tests/test_poly_dense.py
GOLDENS = [
    ("degree", ([3, 0, 0, 0, 179, 0, 0, 6],), 7),
    ("degree", ([29, 112, 68],), 2),
    ("degree", ([3, 0, 0, 0, 179, 0, 0, 6] + [0] * 7,), 7),
    ("degree", ([],), 0),
    ("degree", ([0, 0],), 0),
    ("evaluate", ([1, 1, 1], 2), 7),
    ("evaluate", ([1, 1, 4], 2), 19),
    ("evaluate", ([1, 2, 3, 4], 3), 142),
    ("add", ([4, 5, 6], [1, 2, 3, 0]), [5, 7, 9, 0]),
    ("add", ([234, 100, 6], [123, 234, 3]), [106, 83, 9]),
    ("add", ([], [1, 2, 3]), [1, 2, 3]),
    ("mul", ([4, 5, 6], [1, 2, 3, 0]), [4, 13, 28, 27, 18]),
    ("mul", ([234, 100, 6], [123, 234, 3]), [168, 39, 242, 198, 18]),
    ("mul", ([], []), [0]),
    ("mul", ([0], [1, 2, 3]), [0, 0, 0]),
    ("scalar_mul", ([1, 2, 3], 69), [69, 138, 207]),
    ("scalar_mul", ([20, 2, 3], 69), [125, 138, 207]),
    ("polynomial_division", ([3, 0, 0, 0, 179, 0, 0, 6], [29, 112, 68]),
     ([209, 207, 78, 1, 131, 37], [217, 207])),
    ("polynomial_division", ([1, 0, 3, 1], [0, 0, 9, 1]), ([1], [1, 0, 245])),
    # divisor of higher degree than the dividend
    ("polynomial_division", ([1, 2], [1, 2, 3]), ([0], [0])),
    # div drops the remainder
    ("div", ([3, 0, 0, 0, 179, 0, 0, 6], [29, 112, 68]),
     [209, 207, 78, 1, 131, 37]),
    ("root_poly", ([1, 2, 3],), [245, 11, 245, 1]),
]
_WITH_FIELD = ("evaluate", "add", "mul", "scalar_mul", "polynomial_division",
               "div", "root_poly")


@pytest.mark.parametrize("i", range(len(GOLDENS)))
def test_dense_goldens_match_jax(i):
    name, args, golden = GOLDENS[i]
    if name in _WITH_FIELD:
        mine = getattr(dense, name)(Z251, *args)
        theirs = getattr(jdense, name)(jhost.Z251, *args)
    else:
        mine = getattr(dense, name)(*args)
        theirs = getattr(jdense, name)(*args)
    assert mine == theirs == golden


@pytest.mark.parametrize("divisor", [[], [0], [0, 0, 0]])
def test_division_by_zero_raises_in_both(divisor):
    for mod, f in ((dense, Z251), (jdense, jhost.Z251)):
        with pytest.raises(ZeroDivisionError, match="Dividend must be"):
            mod.polynomial_division(f, [1, 2, 3], divisor)


@pytest.mark.parametrize("fname", sorted(FIELDS))
def test_dense_random_match_jax(fname):
    f, jf = FIELDS[fname]
    rng = random.Random(5150)
    for _ in range(40):
        a = [rng.randrange(f.p) for _ in range(rng.randrange(0, 9))]
        b = [rng.randrange(f.p) for _ in range(rng.randrange(1, 6))]
        if rng.random() < 0.3:
            a = a + [0] * rng.randrange(1, 3)     # trailing zeros
        x = rng.randrange(f.p)
        assert dense.degree(a) == jdense.degree(a)
        assert dense.remove_leading_zeros(a) == jdense.remove_leading_zeros(a)
        assert dense.evaluate(f, a, x) == jdense.evaluate(jf, a, x)
        for name in ("add", "sub", "mul"):
            assert getattr(dense, name)(f, a, b) == \
                getattr(jdense, name)(jf, a, b), name
        assert dense.neg(f, a) == jdense.neg(jf, a)
        assert dense.scalar_mul(f, a, x) == jdense.scalar_mul(jf, a, x)
        if any(b):
            q, r = dense.polynomial_division(f, a, b)
            assert (q, r) == jdense.polynomial_division(jf, a, b)
            assert dense.div(f, a, b) == q
            if dense.degree(b) <= dense.degree(a):
                # a = q b + r
                back = dense.add(f, dense.mul(f, q, b), r)
                assert dense.remove_leading_zeros(back) == \
                    dense.remove_leading_zeros([c % f.p for c in a])
        roots = rng.sample(range(1, 60), 4)
        pts = [(r, rng.randrange(f.p)) for r in roots[:2]]
        assert dense.lagrange_basis(f, roots, roots[0]) == \
            jdense.lagrange_basis(jf, roots, roots[0])
        assert dense.interpolate(f, roots, pts) == \
            jdense.interpolate(jf, roots, pts)
        assert dense.root_poly(f, roots) == jdense.root_poly(jf, roots)
    assert dense.interpolate(f, [1, 2], []) == [0]


# ---------------------------------------------------------------------------
# field.host
# ---------------------------------------------------------------------------

def test_ext_euc_and_crt_match_jax():
    rng = random.Random(77)
    for _ in range(200):
        a, b = rng.randrange(1, 1 << 80), rng.randrange(1, 1 << 80)
        g, s, t = host.ext_euc_alg(a, b)
        assert (g, s, t) == jhost.ext_euc_alg(a, b)
        assert g == s * a + t * b and a % g == 0 and b % g == 0
    moduli = [3, 5, 7, 11, 13, 251]
    for _ in range(50):
        rems = [rng.randrange(m) for m in moduli]
        x = host.chinese_remainder(rems, moduli)
        assert x == jhost.chinese_remainder(rems, moduli)
        assert [x % m for m in moduli] == rems
    assert host.chinese_remainder([2, 3], [3, 5]) == \
        jhost.chinese_remainder([2, 3], [3, 5])


@pytest.mark.parametrize("fname", sorted(FIELDS))
def test_random_elem_and_powers_match_jax(fname):
    f, jf = FIELDS[fname]
    r1, r2 = random.Random(9), random.Random(9)
    mine = [f.random_elem(r1) for _ in range(300)]
    assert mine == [jf.random_elem(r2) for _ in range(300)]
    assert all(0 < v < f.p for v in mine)
    x = mine[0]
    g, jg = f.powers(x), jf.powers(x)
    got = [next(g) for _ in range(20)]
    assert got == [next(jg) for _ in range(20)]
    assert got[:3] == [1, x, x * x % f.p]


@pytest.mark.parametrize("fname,n", [("z251", 5), ("z251", 10),
                                     ("fr", 8), ("fr", 16)])
def test_dft_idft_match_jax(fname, n):
    f, jf = FIELDS[fname]
    if fname == "z251":
        # 6 generates GF(251)*, of order 250 = 2 * 5^3
        root = pow(6, 250 // n, 251)
    else:
        from zksnark_tpu_torch.field import params
        root = pow(params.FR_ROOT_OF_UNITY,
                   (1 << params.FR_TWO_ADICITY) // n, f.p)
    assert pow(root, n, f.p) == 1 and pow(root, n // 2, f.p) != 1
    rng = random.Random(n)
    seq = [rng.randrange(f.p) for _ in range(n)]
    out = f.dft(seq, root)
    assert out == jf.dft(seq, root)
    assert out[1] == dense.evaluate(f, seq, root)
    back = f.idft(out, root)
    assert back == jf.idft(out, root) == seq


# ---------------------------------------------------------------------------
# QAP and the R1CS array exports
# ---------------------------------------------------------------------------

def _qap_fields(q):
    return (q.u, q.v, q.w, q.t, q.input, q.degree, q.num_wires)


@pytest.mark.parametrize("fname", sorted(FIELDS))
@pytest.mark.parametrize("path", PROGRAMS, ids=lambda p: p.name)
def test_from_r1cs_and_exports_match_jax(path, fname):
    mine, theirs = _parse(path, fname)
    f, jf = FIELDS[fname]
    q, jq = from_r1cs(f, mine), jqap.from_r1cs(jf, theirs)
    assert _qap_fields(q) == _qap_fields(jq)
    assert q.field.p == jq.field.p
    for a, b in zip(mine.dense_point_matrices(),
                    theirs.dense_point_matrices()):
        assert a.dtype == b.dtype == object and a.shape == b.shape
        assert a.tolist() == b.tolist()
    for (w, g, v), (jw, jg, jv) in zip(mine.coo(), theirs.coo()):
        assert w.dtype == jw.dtype == np.int32
        assert g.dtype == jg.dtype == np.int32
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(g, jg)
        assert v == jv


# ---------------------------------------------------------------------------
# host setup / prove: the JSON text of both packages
# ---------------------------------------------------------------------------

_JBACKENDS: dict = {}
_BACKENDS: dict = {}


def _backends(fname):
    if fname not in _BACKENDS:
        _BACKENDS[fname] = (BN254Backend if fname == "fr" else Z251Backend)()
        _JBACKENDS[fname] = (jbackend.BN254Backend if fname == "fr"
                             else jbackend.Z251Backend)()
    return _BACKENDS[fname], _JBACKENDS[fname]


CIRCUITS = {"simple.zk": ([3, 2, 4], [2, 34]),
            "lispesque_quad.zk": ([5, 2, 3, 7], None)}


@pytest.mark.parametrize("mode", ["pinned", "seeded"])
@pytest.mark.parametrize("fname", sorted(FIELDS))
@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_host_setup_prove_json_equals_jax(circuit, fname, mode):
    path = ROOT / "test_programs" / circuit
    mine, theirs = _parse(path, fname)
    f, jf = FIELDS[fname]
    be, jbe = _backends(fname)
    q, jq = from_r1cs(f, mine), jqap.from_r1cs(jf, theirs)
    code = path.read_text()
    inputs, public = CIRCUITS[circuit]
    w = witness.weights(code, inputs, f)
    assert w == jwitness.weights(code, inputs, jf)
    public = public or w[1:1 + mine.input]
    if mode == "pinned":
        kw = dict(trapdoor=(111, 222, 333, 444, 555))
        pkw, jpkw = dict(blinding=(7, 9)), dict(blinding=(7, 9))
        kw_j = kw
    else:
        kw, kw_j = dict(rng=random.Random(31)), dict(rng=random.Random(31))
        pkw, jpkw = dict(rng=kw["rng"]), dict(rng=kw_j["rng"])
    crs = protocol.setup(be, q, **kw)
    jcrs = jprotocol.setup(jbe, jq, **kw_j)
    text = ser.crs_to_json(*crs)
    assert text == jser.crs_to_json(*jcrs)
    proof = protocol.prove(be, q, crs, w, **pkw)
    jproof = jprotocol.prove(jbe, jq, jcrs, w, **jpkw)
    ptext = ser.proof_to_json(proof)
    assert ptext == jser.proof_to_json(jproof)
    # each codec reads the other's text back to the same values
    assert ser.crs_to_json(*ser.crs_from_json(jser.crs_to_json(*jcrs))) \
        == text
    assert jser.crs_to_json(*jser.crs_from_json(text)) == text
    assert ser.proof_from_json(jser.proof_to_json(jproof)) == proof
    assert protocol.verify(be, crs, public, proof)
    bad = [public[0] + 1] + list(public[1:])
    assert not protocol.verify(be, crs, bad, proof)
    if fname == "fr":
        assert protocol.verify_fast(be, crs, public, proof)


# ---------------------------------------------------------------------------
# the Z251 accept / reject cases of tests/test_groth16_z251.py
# ---------------------------------------------------------------------------

def single_mult_qap():
    return QAP(u=[[0], [0], [1], [0]], v=[[0], [0], [0], [1]],
               w=[[0], [1], [0], [0]], t=[250, 1], input=2, degree=1,
               field=Z251)


def _jax_qap(q):
    return jqap.QAP(u=q.u, v=q.v, w=q.w, t=q.t, input=q.input,
                    degree=q.degree, field=jhost.Z251)


def test_single_mult_honest_with_crs_introspection():
    qap = single_mult_qap()
    jq = _jax_qap(qap)
    jbe = jbackend.Z251Backend()
    weights = [1, 17, 100, 83]
    rng, jrng = random.Random(42), random.Random(42)
    for _ in range(100):
        sigmag1, sigmag2 = protocol.setup(BE, qap, rng=rng)
        jcrs = jprotocol.setup(jbe, jq, rng=jrng)
        assert ser.crs_to_json(sigmag1, sigmag2) == jser.crs_to_json(*jcrs)

        inv69 = Z251.inv(69)
        alpha = Z251.mul(sigmag1.alpha, inv69)
        beta = Z251.mul(sigmag1.beta, inv69)
        gamma = Z251.mul(sigmag2.gamma, inv69)
        delta = Z251.mul(sigmag1.delta, inv69)
        assert len(sigmag1.xi) == 1
        assert sigmag1.xi[0] == BE.encrypt_g1(1)
        assert len(sigmag1.sum_gamma) == 3
        assert sigmag1.sum_gamma[0] == BE.encrypt_g1(0)
        assert sigmag1.sum_gamma[1] == BE.encrypt_g1(Z251.div(1, gamma))
        assert sigmag1.sum_gamma[2] == BE.encrypt_g1(Z251.div(beta, gamma))
        assert len(sigmag1.sum_delta) == 1
        assert sigmag1.sum_delta[0] == BE.encrypt_g1(Z251.div(alpha, delta))
        assert len(sigmag1.xi_t) == 0
        assert len(sigmag2.xi) == 1
        assert sigmag2.xi[0] == BE.encrypt_g2(1)

        proof = protocol.prove(BE, qap, (sigmag1, sigmag2), weights, rng=rng)
        jproof = jprotocol.prove(jbe, jq, jcrs, weights, rng=jrng)
        assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)
        assert protocol.verify(BE, (sigmag1, sigmag2), [17, 100], proof)


def test_single_mult_random_proof_soundness():
    """Random proofs verify with probability ~1/251."""
    qap = single_mult_qap()
    rng = random.Random(7)
    total, count = 6000, 0
    for _ in range(total):
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.Proof(
            a=BE.random_g1(rng), b=BE.random_g2(rng), c=BE.random_g1(rng))
        if protocol.verify(BE, crs, [17, 100], proof):
            count += 1
    ratio = count / total
    assert 0.001 < ratio < 0.009, ratio


def quad_share_hand_qap():
    u = [[1, 124, 126], [0, 127, 125]] + [[0, 0, 0]] * 6
    v = [[0, 0, 0]] * 3 + [[3, 123, 126], [248, 4, 250], [1, 124, 126],
                           [248, 4, 250], [1, 124, 126]]
    w = [[0, 0, 0]] * 2 + [[1, 124, 126]] + [[0, 0, 0]] * 3 + \
        [[3, 123, 126], [248, 4, 250]]
    return QAP(u=u, v=v, w=w, t=[245, 11, 245, 1], input=2, degree=3,
               field=Z251)


def quad_share_weights(rng):
    x, a, b, c = (Z251.random_elem(rng) for _ in range(4))
    share = (a * x * x + b * x + c) % 251
    weights = [1, x, share, a, b, c, (a * x) % 251,
               (x * (a * x + b)) % 251]
    return weights, [x, share]


def test_quadratic_share_honest():
    qap = quad_share_hand_qap()
    rng = random.Random(11)
    for _ in range(100):
        weights, inputs = quad_share_weights(rng)
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        assert protocol.verify(BE, crs, inputs, proof)


def test_quadratic_share_reject_wrong_input():
    qap = quad_share_hand_qap()
    rng = random.Random(13)
    rejected = 0
    for _ in range(50):
        weights, inputs = quad_share_weights(rng)
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        bad = [(inputs[0] + 1) % 251, inputs[1]]
        if not protocol.verify(BE, crs, bad, proof):
            rejected += 1
    assert rejected >= 48


def test_qap_from_roots():
    r1cs = R1CS(
        u=[[(3, 1)], [(1, 1), (2, 1)], [], [], [], [], [], []],
        v=[[], [], [], [(1, 1)], [(2, 1)], [(3, 1)], [(2, 1)], [(3, 1)]],
        w=[[], [], [(3, 1)], [], [], [], [(1, 1)], [(2, 1)]],
        roots=[1, 2, 3], input=2)
    qap = from_r1cs(Z251, r1cs)
    rng = random.Random(17)
    for _ in range(100):
        weights, inputs = quad_share_weights(rng)
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        assert protocol.verify(BE, crs, inputs, proof)


def test_qap_from_file_legacy():
    rng = random.Random(19)
    code = (ROOT / "test_programs" / "quad_share.zk").read_text()
    qap = from_r1cs(Z251, legacy.parse(code, Z251))
    for _ in range(50):
        weights, inputs = quad_share_weights(rng)
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        assert protocol.verify(BE, crs, inputs, proof)

    code = (ROOT / "test_programs" / "cubic_share.zk").read_text()
    qap = from_r1cs(Z251, legacy.parse(code, Z251))
    for _ in range(50):
        x, a, b, c, d = (Z251.random_elem(rng) for _ in range(5))
        share = (((a * x + b) * x + c) * x + d) % 251
        weights = [1, x, share, a, b, c, d, (a * x) % 251,
                   ((a * x + b) * x) % 251, (((a * x + b) * x + c) * x) % 251]
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        assert protocol.verify(BE, crs, [x, share], proof)


def test_qap_from_ast():
    rng = random.Random(23)
    code = (ROOT / "test_programs" / "lispesque_quad.zk").read_text()
    qap = from_r1cs(Z251, compiler.parse(code, Z251))
    for _ in range(50):
        x, a, b, c = (Z251.random_elem(rng) for _ in range(4))
        share = (a * x * x + b * x + c) % 251
        weights = [1, x, share, (a * x) % 251, a,
                   (x * (a * x + b)) % 251, b, c]
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        assert protocol.verify(BE, crs, [x, share], proof)

    code = (ROOT / "test_programs" / "lispesque_cubic.zk").read_text()
    qap = from_r1cs(Z251, compiler.parse(code, Z251))
    for _ in range(50):
        x, a, b, c, d = (Z251.random_elem(rng) for _ in range(5))
        share = (a * x**3 + b * x**2 + c * x + d) % 251
        weights = [1, x, share, (a * x) % 251, a,
                   (x * (a * x + b)) % 251, b,
                   (x * (x * (a * x + b) + c)) % 251, c, d]
        crs = protocol.setup(BE, qap, rng=rng)
        proof = protocol.prove(BE, qap, crs, weights, rng=rng)
        assert protocol.verify(BE, crs, [x, share], proof)
