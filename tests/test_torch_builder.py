"""The port's circuit builder and host Keccak-256 against the JAX package's,
on the CPU.

- gate truth tables, the u8 comparators, u64_add / u64_sub: the same
  sub-circuits and the same values in both packages; validate_balance's
  balance wire and commitment;
- keccakf_1600 and keccak256 of 0, 4 and 137 bytes (two blocks): the
  in-circuit digest equals both packages' `keccak_host`;
- the 4-byte Keccak-256 instance of `examples/keccak_proof.py` (232,016
  gates), built once per package: its `r1cs()` and its `weights` are equal;
- the OR instance of `tests/test_builder.py` over FR, proved by the port
  on the CPU under a pinned trapdoor and blinding, gives the JAX
  `device_prove` proof (affine points), and it verifies.
Tolerance: exact equality.
"""

import random

import pytest
import torch

from zksnark_tpu.builder import words as jwords
from zksnark_tpu.builder.circuit import Circuit as JCircuit
from zksnark_tpu.builder.instance import CircuitInstance as JInstance
from zksnark_tpu.field import host as jhost
from zksnark_tpu.utils import keccak_host as jkeccak
from zksnark_tpu_torch.builder import words
from zksnark_tpu_torch.builder.circuit import Circuit
from zksnark_tpu_torch.builder.instance import CircuitInstance
from zksnark_tpu_torch.examples import keccak_proof
from zksnark_tpu_torch.field import host
from zksnark_tpu_torch.utils import keccak_host

TD = (111, 222, 333, 444, 555)
BL = (666, 777)
torch.set_num_threads(1)     # small tensors: threads only add overhead

BOTH = ((Circuit, host.Z251), (JCircuit, jhost.Z251))


@pytest.mark.parametrize("gate", ["new_and", "new_or", "new_xor", "new_nand",
                                  "new_nor", "new_xnor", "new_not",
                                  "new_bit_checker"])
def test_gate_truth_tables(gate):
    unary = gate in ("new_not", "new_bit_checker")
    vals = [(a,) for a in (0, 1, 2, 250)] if unary else \
        [(a, b) for a in (0, 1) for b in (0, 1)]
    results = []
    for cls, f in BOTH:
        out = []
        for v in vals:
            c = cls(f)
            ws = [c.new_wire() for _ in v]
            o = getattr(c, gate)(*ws)
            for w, x in zip(ws, v):
                c.set_value(w, x)
            out.append(c.evaluate(o))
        results.append((out, c.subs, c.wire_assignments))
    assert results[0] == results[1]
    if gate == "new_xor":
        assert results[0][0] == [0, 1, 1, 0]


def test_comparators_u8_sweep():
    rng = random.Random(2)
    cases = [(rng.randrange(256), rng.randrange(256)) for _ in range(40)]
    cases += [(0, 0), (255, 255), (0, 255), (255, 0), (127, 128), (128, 127)]
    results = []
    for cls, f in BOTH:
        c = cls(f)
        left, right = c.new_word8(), c.new_word8()
        outs = [c.greater_than(left, right), c.less_than(left, right),
                c.greater_than_eq(left, right), c.less_than_eq(left, right),
                c.is_equal(left, right), c.is_equal_zero(left)]
        got = []
        for a, b in cases:
            c.reset()
            c.set_word8(left, a)
            c.set_word8(right, b)
            got.append([c.evaluate(o) for o in outs])
        results.append((got, c.subs))
    assert results[0] == results[1]
    assert results[0][0] == [[int(a > b), int(a < b), int(a >= b),
                              int(a <= b), int(a == b), int(a == 0)]
                             for a, b in cases]


def test_u64_add_sub_and_words():
    rng = random.Random(77)
    pairs = [(rng.getrandbits(64), rng.getrandbits(64)) for _ in range(6)]
    pairs += [(0, 1), ((1 << 64) - 1, 1)]
    results = []
    for cls, f in BOTH:
        c = cls(f)
        got = []
        for x, y in pairs:
            wx, wy = c.set_new_word64(x), c.set_new_word64(y)
            got.append((c.evaluate_to_num(c.u64_add(wx, wy)),
                        c.evaluate_to_num(c.u64_sub(wx, wy))))
        results.append((got, c.subs))
    assert results[0] == results[1]
    assert results[0][0] == [((x + y) % (1 << 64), (x - y) % (1 << 64))
                             for x, y in pairs]
    wd = list(range(64))
    for by in (0, 1, 13, 63, 64):
        assert words.rotate_word64_left(words.word64(wd), by) == \
            jwords.rotate_word64_left(jwords.word64(wd), by)
        assert words.rotate_word64_right(words.word64(wd), by) == \
            jwords.rotate_word64_right(jwords.word64(wd), by)
    assert (words.RC, words.RHO, words.PI) == (jwords.RC, jwords.RHO,
                                               jwords.PI)


def test_keccakf_1600():
    """The port's permutation in-circuit equals both packages' host
    permutation (the gadget's sub-circuits equal the JAX package's: see
    the 4-byte instance's R1CS below)."""
    rng = random.Random(3)
    lanes = [rng.getrandbits(64) for _ in range(25)]
    want = keccak_host.keccak_f1600(lanes)
    assert want == jkeccak.keccak_f1600(lanes)
    c = Circuit(host.Z251)
    state = [c.set_new_word64(v) for v in lanes]
    c.keccakf_1600(state)
    assert [c.evaluate_to_num(w) for w in state] == want


@pytest.mark.parametrize("n_bytes", [0, 137])
def test_keccak256_in_circuit(n_bytes):
    """137 bytes absorb two blocks (the rate is 136)."""
    rng = random.Random(4 + n_bytes)
    data = [rng.randrange(256) for _ in range(n_bytes)]
    want = keccak_host.keccak256(data)
    assert want == jkeccak.keccak256(data)
    c = Circuit(host.Z251)
    digest = c.keccak256_stream(c.set_new_word8_vec(data))
    assert bytes(c.evaluate_to_num(w) for w in digest) == want


def test_validate_balance():
    """z == x - y mod 2^64 sets the balance wire, z + 1 clears it; the
    commitment to x is the host Keccak-256 of its 8 little-endian
    bytes."""
    rng = random.Random(78)
    x, y = rng.getrandbits(64), rng.getrandbits(64)
    z = (x - y) % (1 << 64)
    c = Circuit(host.Z251)
    wx, wy, wz = (c.set_new_word64(v) for v in (x, y, z))
    out = c.validate_balance(wx, wy, wz)
    assert c.evaluate(out["is_z_eq_x_min_y"]) == 1
    assert bytes(c.evaluate_to_num(w) for w in out["x_hash"]) == \
        jkeccak.keccak256(list(x.to_bytes(8, "little")))
    c.reset()
    for w, v in ((wx, x), (wy, y), (wz, (z + 1) % (1 << 64))):
        c.set_word64(w, v)
    assert c.evaluate(out["is_z_eq_x_min_y"]) == 0


@pytest.fixture(scope="module")
def keccak4():
    """The 4-byte preimage instance, built by each package."""
    pre = keccak_proof.preimage_of(4)
    bits = keccak_proof.bits_of(pre)
    c, inst, n_checkers = keccak_proof.build(4)
    jc = JCircuit(jhost.FR)
    inp = jc.new_word8_vec(4)
    hw = jc.keccak256(inp)
    bc = jc.bit_check(jwords.flatten_word8(inp))
    jinst = JInstance(jc, jwords.flatten_word8(hw) + bc,
                      jwords.flatten_word8(inp),
                      lambda sc: jhost.FR.from_int(sc + 1))
    return dict(pre=pre, c=c, inst=inst, n_checkers=n_checkers,
                weights=inst.weights(bits), jweights=jinst.weights(bits),
                r1cs=inst.r1cs(), jr1cs=jinst.r1cs())


def test_keccak_instance_r1cs_equal(keccak4):
    r, jr = keccak4["r1cs"], keccak4["jr1cs"]
    assert (r.num_gates, r.num_wires, r.input) == (232016, 232050, 288)
    assert r.roots == jr.roots and r.input == jr.input
    for a, b in ((r.u, jr.u), (r.v, jr.v), (r.w, jr.w)):
        assert a == b


def test_keccak_instance_weights_equal(keccak4):
    w = keccak4["weights"]
    assert w == keccak4["jweights"]
    # the verify wires hold the digest bits and zero checkers, and the
    # in-circuit digest is the host Keccak-256 of the preimage
    digest = keccak_host.keccak256(keccak4["pre"])
    assert digest == jkeccak.keccak256(keccak4["pre"])
    public = keccak_proof.public_inputs(digest, keccak4["n_checkers"])
    assert w[1:1 + len(public)] == public
    assert len(w) == keccak4["r1cs"].num_wires


def _or_instance(cls, inst_cls, f):
    c = cls(f)
    x = c.new_wire()
    x_checker = c.new_bit_checker(x)
    y = c.new_wire()
    y_checker = c.new_bit_checker(y)
    or_wire = c.new_or(x, y)
    return inst_cls(c, [x_checker, y_checker, or_wire], [x, y],
                    lambda sc: f.from_int(sc + 1))


def test_builder_circuit_proof_equals_jax():
    from zksnark_tpu.groth16 import prover as jprover
    from zksnark_tpu_torch.groth16 import protocol, prover
    from zksnark_tpu_torch.groth16.backend import BN254Backend

    inst = _or_instance(Circuit, CircuitInstance, host.FR)
    jinst = _or_instance(JCircuit, JInstance, jhost.FR)
    r1cs, jr1cs = inst.r1cs(), jinst.r1cs()
    assert (r1cs.u, r1cs.v, r1cs.w, r1cs.roots, r1cs.input) == \
        (jr1cs.u, jr1cs.v, jr1cs.w, jr1cs.roots, jr1cs.input)
    w = inst.weights([0, 1])
    assert w == jinst.weights([0, 1])
    assert r1cs.check_satisfied(w, host.FR.p) == []

    dq = prover.compile_r1cs(r1cs, device="cpu")
    crs = prover.device_setup(dq, trapdoor=TD)
    proof = prover.device_prove(dq, crs, w, blinding=BL)
    jq = jprover.compile_r1cs(jr1cs)
    jproof = jprover.device_prove(
        jq, jprover.device_setup(jq, trapdoor=TD), w, blinding=BL)
    assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)

    be = BN254Backend()
    pair = (crs.sigmag1, crs.sigmag2)
    assert protocol.verify_fast(be, pair, [0, 0, 1], proof)
    assert not protocol.verify_fast(be, pair, [0, 0, 0], proof)
    assert not protocol.verify_fast(be, pair, [1, 0, 1], proof)
