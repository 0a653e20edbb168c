"""The port's builder beyond product gates (`zksnark_tpu_torch/builder/`):
hint wires, constraints with a given (possibly empty) C, private bit
checks, the libsnark gadgets (`pack`, `lastbits_add`, `multipack`), and
SHA256Compress and the Sprout Merkle path built from them.

- Each gadget's R1CS is satisfied by the builder's witness, and a wrong
  value in a hint wire (the witness edited) breaks a gate.
- `CircuitInstance.weights` starts from a reset circuit: a second call
  with other inputs gives that statement's wires, not the last call's;
  it sets gates and hints in build order and reports a wire no input
  reaches.
- `sha256_compress` from the standard IV on one padded block equals
  FIPS 180-4's one-block vectors and `hashlib.sha256`; 26,968 gates a
  compression (libsnark's gadget: ~27,904; the limit is 32,000).
- A depth-2 path's public elements equal the plain reference's
  (`benchmark/reference/sprout_path.py`) packing of its root.
- The existing gates keep their rows: a product gate's R1CS is the one
  the builder made before (a product's C is its output wire alone).
Tolerance: exact equality.
"""

import hashlib
import random
import struct

import pytest

from benchmark.reference import sprout_path as ref
from zksnark_tpu_torch.builder import sha256
from zksnark_tpu_torch.builder.circuit import Circuit, UNITY_WIRE
from zksnark_tpu_torch.builder.instance import CircuitInstance
from zksnark_tpu_torch.field.host import FR

P = FR.p


def _instance(c, verify, inputs):
    return CircuitInstance(c, verify, inputs, lambda sc: FR.from_int(sc + 1))


def _bad_gates(inst, w):
    return inst.r1cs().check_satisfied(w, P)


def _adder():
    """Two 4-bit words packed and added with a constant by
    `lastbits_add`, the bits checked, the sum multipacked 3 bits at a
    time into public wires."""
    c = Circuit(FR)
    a = [c.new_wire() for _ in range(4)]
    b = [c.new_wire() for _ in range(4)]
    for bit in a + b:
        c.enforce_bit(bit)
    total = c.lastbits_add([(1, c.pack(a)), (1, c.pack(b))], 5, 4, 2)
    pub = c.multipack(total, chunk=3)
    return c, _instance(c, pub, a + b), total


def _bits(x, k):
    return [(x >> i) & 1 for i in range(k)]


@pytest.mark.parametrize("x,y", [(0, 0), (3, 9), (15, 15), (7, 12)])
def test_packed_adder_is_satisfied(x, y):
    c, inst, total = _adder()
    w = inst.weights(_bits(x, 4) + _bits(y, 4))
    assert _bad_gates(inst, w) == []
    s = (x + y + 5) % 16
    assert [c.evaluate(t) for t in total] == _bits(s, 4)
    assert w[1:3] == [s & 7, s >> 3]          # the two public elements


def test_wrong_hint_value_is_rejected():
    c, inst, total = _adder()
    w = inst.weights(_bits(6, 4) + _bits(11, 4))
    for wire in (total[0], total[3]):
        pos = inst.ordered_wires.index(wire)
        bad = list(w)
        bad[pos] = 1 - bad[pos]
        assert _bad_gates(inst, bad), wire
        bad[pos] = 2                            # not a bit
        assert _bad_gates(inst, bad), wire


def test_constraint_rows_and_empty_c():
    """A constraint emits its given C in w (merged, zero terms dropped)
    and makes no wire; an empty C emits nothing; a product gate's C is
    its output wire with weight one."""
    c = Circuit(FR)
    x, y = c.new_wire(), c.new_wire()
    z = c.new_hint(lambda a, b: a * b + 3, [x, y])
    before = c.num_wires()
    c.new_constraint([(1, x)], [(1, y)], [(1, z), (-3, UNITY_WIRE),
                                          (2, x), (-2, x)])
    c.enforce_bit(x)
    assert c.num_wires() == before
    prod = c.new_and(x, y)
    inst = _instance(c, [z], [x, y])
    r1 = inst.r1cs()
    col = {wire: i for i, wire in enumerate(inst.ordered_wires)}
    assert r1.w[col[z]] == [(1, 1)]
    assert r1.w[col[UNITY_WIRE]] == [(1, P - 3)]
    assert r1.w[col[x]] == []                  # 2x - 2x dropped
    assert r1.w[col[prod]] == [(3, 1)]
    assert r1.u[col[x]] == [(1, 1), (2, 1), (3, 1)]
    assert r1.v[col[x]] == [(2, 1)]
    w = inst.weights([1, 5])
    assert w[col[z]] == 8 and _bad_gates(inst, w) == []
    bad = list(w)
    bad[col[z]] = 9
    assert _bad_gates(inst, bad) == [1]        # the constraint's root


def test_private_bit_check():
    c = Circuit(FR)
    x = c.new_wire()
    c.enforce_bit(x)
    inst = _instance(c, [], [x])
    for v, ok in ((0, True), (1, True), (2, False), (P - 1, False)):
        assert (_bad_gates(inst, inst.weights([v])) == []) == ok


def test_weights_starts_from_a_reset_circuit():
    """A second statement's witness is its own, on the Keccak path and
    the adder alike (before, `weights` returned the first call's wires
    unless `circuit.reset()` ran first)."""
    c, inst, _ = _adder()
    first = inst.weights(_bits(1, 4) + _bits(2, 4))
    second = inst.weights(_bits(9, 4) + _bits(4, 4))
    assert first != second
    assert second == _adder()[1].weights(_bits(9, 4) + _bits(4, 4))
    k = Circuit(FR)
    data = k.new_word8_vec(2)
    digest = k.keccak256(data)
    kin = _instance(k, [b for byte in digest for b in byte],
                    [b for byte in data for b in byte])
    a = kin.weights(_bits(0x1234, 16))
    b = kin.weights(_bits(0xBEEF, 16))
    assert a != b
    assert b == kin.weights(_bits(0xBEEF, 16))


def test_weights_runs_in_build_order_and_reports_unset_wires():
    """`weights` sets gates and hints in build order (a hint reading a
    product's output, a product reading a hint's); a wire no input
    reaches is reported by name, as `evaluate` reports it."""
    c = Circuit(FR)
    x = c.new_wire()
    sq = c.new_and(x, x)
    h = c.new_hint(lambda v: v + 1, [sq])
    top = c.new_and(h, x)
    inst = _instance(c, [top], [x])
    assert inst.weights([3])[1] == 30
    loose = c.new_wire()
    c.new_and(x, loose)
    with pytest.raises(ValueError, match=f"wire {loose}"):
        _instance(c, [top], [x]).weights([3])


def _pad(msg: bytes) -> bytes:
    return (msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64)
            + struct.pack(">Q", 8 * len(msg)))


@pytest.fixture(scope="module")
def compress():
    c = Circuit(FR)
    block = [c.new_wire() for _ in range(512)]
    out = sha256.sha256_compress(c, sha256.const_stream(c, sha256.IV),
                                 block)
    return c, _instance(c, [], block), out


FIPS = {  # FIPS 180-4 example vectors that fit one block
    b"abc": "ba7816bf8f01cfea414140de5dae2223"
            "b00361a396177a9cb410ff61f20015ad",
    b"": "e3b0c44298fc1c149afbf4c8996fb924"
         "27ae41e4649b934ca495991b7852b855",
}


@pytest.mark.parametrize("msg", [b"abc", b"", bytes(range(55)),
                                 b"zksnark " * 5])
def test_sha256_compress_against_fips_and_hashlib(compress, msg):
    c, inst, out = compress
    w = inst.weights(sha256.bytes_stream(_pad(msg)))
    bits = [c.evaluate(b) for b in out]
    digest = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                   for i in range(0, 256, 8))
    assert digest == hashlib.sha256(msg).digest()
    if msg in FIPS:
        assert digest.hex() == FIPS[msg]
    assert _bad_gates(inst, w) == []


def test_compression_gate_count(compress):
    c, _, _ = compress
    assert c.num_sub_circuits() == 26968 <= 32000


def test_depth2_path_matches_the_reference():
    from benchmark.circuits.sprout_path import Circuit as Path, statement

    cfg = {"depth": 2}
    path = Path(cfg)
    for seed in (1, 2):
        st = statement(cfg, random.Random(seed))
        w = path.witness(st)
        root = ref.merkle_root(*st)
        assert w[1:3] == ref.packed_root(root)
        assert _bad_gates(path.instance, w) == []
    leaf, pos, sibs = st
    assert ref.merkle_root(leaf, 0, sibs[:1]) == ref.merkle_crh(leaf, sibs[0])
