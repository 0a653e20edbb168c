"""The plain reference: its Keccak-256, its Lagrange basis and groups,
and its proofs against the prover's on the CPU."""

import random

import pytest

from benchmark import session
from benchmark.reference import bn254, groth16, keccak
from benchmark.reference import keccak256 as rk

R = groth16.R


def test_keccak256_vectors():
    assert keccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")


@pytest.mark.parametrize("n", [0, 4, 135, 136, 137, 300])
def test_keccak256_against_the_ports_host_hash(n):
    from zksnark_tpu_torch.utils.keccak_host import keccak256

    data = bytes(random.Random(n).randrange(256) for _ in range(n))
    assert keccak.keccak256(data) == bytes(keccak256(list(data)))


@pytest.mark.parametrize("n_gates", [1, 3, 5, 8])
def test_lagrange_against_the_product_formula(n_gates):
    x = 987654321987654321
    lag = groth16.Lagrange(x, n_gates)
    n = lag.n
    omega = pow(pow(5, (R - 1) >> 28, R), (1 << 28) // n, R)
    pts = [pow(omega, j, R) for j in range(n)]
    for g in range(n_gates):
        want = 1
        for j in range(n):
            if j != g:
                want = want * (x - pts[j]) * pow(pts[g] - pts[j], -1, R) % R
        assert lag.at(g) == want


def test_groups():
    a, b = 123456789, 987654321
    assert bn254.g1_mul(R) is None and bn254.g2_mul(R) is None
    assert bn254.g1_mul(1) == bn254.G1 and bn254.g2_mul(1) == bn254.G2
    from zksnark_tpu_torch.curve import bn254 as hc

    assert bn254.g1_mul(a * b) == hc.g1_scalar_mul(bn254.g1_mul(a), b)
    assert bn254.g2_mul(a) == hc.g2_scalar_mul(hc.G2_GEN, a)


def test_keccak_circuit_sums_equal_the_ports_r1cs():
    """The frozen Keccak circuit's sums at x equal those of the port's
    R1CS and witness, wire by wire."""
    from benchmark.circuits.keccak256 import Circuit

    cfg = {"preimage_bytes": 64}
    ref = rk.Reference(cfg)
    port = Circuit(cfg)
    r1 = port.r1cs()
    pre = bytes(range(7, 7 + 64 * 3, 3))
    wit = port.witness(pre)
    lag = groth16.Lagrange(31415926535897932384626, ref.n_gates)
    sums, errors = ref.sums(pre, lag)
    assert errors == 0
    assert (ref.n_gates, ref.num_wires, ref.public) == (
        r1.num_gates, r1.num_wires, r1.input)
    assert ref.nnz == sum(len(p) for rows in (r1.u, r1.v, r1.w)
                          for p in rows)
    index = {r: i for i, r in enumerate(r1.roots)}
    lg = [lag.at(i) for i in range(r1.num_gates)]

    def col(rows, hi):
        return sum(wit[i] * v * lg[index[r]] for i in range(hi)
                   for r, v in rows[i]) % R

    full, pub = r1.num_wires, r1.input + 1
    assert tuple(sums) == (col(r1.u, full), col(r1.v, full), col(r1.w, full),
                           col(r1.u, pub), col(r1.v, pub), col(r1.w, pub))
    # a preimage with another digest fails the reference's own check
    _, errors = rk.Gates.sums(ref, rk.bits_of(pre), [0] * ref.public, lag)
    assert errors > 0


def _mini(bld_ref, port):
    """The same small builder circuit on both sides: (reference Gates,
    port instance)."""
    from zksnark_tpu_torch.builder.instance import CircuitInstance
    from zksnark_tpu_torch.field.host import FR

    ins = [bld_ref.wire() for _ in range(8)]
    x = bld_ref.gate(rk.XOR, ins[0], ins[1])
    a = bld_ref.gate(rk.AND, x, ins[2])
    n = bld_ref.gate(rk.NOT, a)
    y = bld_ref.gate(rk.XOR, n, rk.UNITY)
    chk = [bld_ref.gate(rk.BIT, w) for w in ins]
    gates = rk.Gates(bld_ref, ins, [n, a] + chk)

    pin = port.new_word8()
    px = port.new_xor(pin[0], pin[1])
    pa = port.new_and(px, pin[2])
    pn = port.new_not(pa)
    port.new_xor(pn, port.unity_wire())
    pchk = port.bit_check(pin)
    inst = CircuitInstance(port, [pn, pa] + pchk, pin,
                           lambda sc: FR.from_int(sc + 1))
    return gates, inst, y


def test_reference_proof_equals_the_ports_on_a_builder_circuit():
    from zksnark_tpu_torch.builder.circuit import Circuit
    from zksnark_tpu_torch.field.host import FR
    from zksnark_tpu_torch.groth16 import prover

    gates, inst, _ = _mini(rk._Builder(), Circuit(FR))
    bits = [1, 0, 1, 1, 0, 0, 1, 0]
    trapdoor = (11, 22, 33, 44, 5555555)
    blinding = (77, 99)
    dq = prover.compile_r1cs(inst.r1cs(), device="cpu")
    crs = prover.device_setup(dq, trapdoor=trapdoor)
    proof = prover.device_prove(dq, crs, inst.weights(bits),
                                blinding=blinding)
    lag = groth16.Lagrange(trapdoor[4], gates.n_gates)
    want_pub = [0, 1] + [0] * 8          # not(and(xor, b2)), and, checkers
    sums, errors = gates.sums(bits, want_pub, lag)
    assert errors == 0
    want = groth16.proof(sums, trapdoor, blinding)
    assert groth16.same(proof, want)
    # another blinding, another statement: not the same proof
    assert not groth16.same(proof, groth16.proof(sums, trapdoor, (77, 98)))
    other, _ = gates.sums([0, 0, 1, 1, 0, 0, 1, 0], want_pub, lag)
    assert not groth16.same(proof, groth16.proof(other, trapdoor, blinding))


@pytest.mark.parametrize("name", [c["name"] for c in
                                  session.load_spec()["configs"]])
def test_config_sizes_are_the_circuits(name):
    spec = session.load_spec()
    entry = {c["name"]: c for c in spec["configs"]}[name]
    cell = next(w["name"] for w in spec["workloads"] if w["config"] == name)
    cfg = session.find_cell(spec, cell).config
    assert entry["file"].endswith(name + ".json")
    ref = session.reference_for(cfg)
    assert ref.n_gates == cfg["gates"]
    assert groth16.log_domain(ref.n_gates) == cfg["log_n"]
    assert ref.public == cfg["public_inputs"]
