"""Zcash Sprout's note-commitment path, built by the prover's circuit
builder (`zksnark_tpu_torch.builder.sha256.merkle_path`): a Merkle
authentication path of SHA256Compress over `depth` levels, the root's
256 bits multipacked into two public inputs.  A statement is a 32-byte
leaf, a `depth`-bit position and `depth` 32-byte siblings; its witness
comes from the builder's `CircuitInstance.weights` on their bits (the
siblings are inputs the hints read; the left and right digests are hint
wires).
"""

from __future__ import annotations

from zksnark_tpu_torch.builder import sha256
from zksnark_tpu_torch.builder.circuit import Circuit as Builder
from zksnark_tpu_torch.builder.instance import CircuitInstance
from zksnark_tpu_torch.field.host import FR


def statement(cfg: dict, rng) -> tuple:
    depth = int(cfg["depth"])

    def digest():
        return bytes(rng.randrange(256) for _ in range(32))

    return digest(), rng.randrange(1 << depth), [digest()
                                                 for _ in range(depth)]


class Circuit:
    def __init__(self, cfg: dict):
        self.depth = int(cfg["depth"])
        c = Builder(FR)
        leaf = [c.new_wire() for _ in range(256)]
        pos = [c.new_wire() for _ in range(self.depth)]
        sibs = [[c.new_wire() for _ in range(256)]
                for _ in range(self.depth)]
        root = sha256.merkle_path(c, leaf, pos, sibs)
        public = c.multipack(root)
        self.circuit = c
        self.instance = CircuitInstance(
            c, public, leaf + pos + [w for s in sibs for w in s],
            lambda sc: FR.from_int(sc + 1))

    def r1cs(self):
        return self.instance.r1cs()

    def witness(self, st) -> list:
        leaf, position, siblings = st
        bits = sha256.bytes_stream(leaf)
        bits += [(position >> i) & 1 for i in range(self.depth)]
        for sib in siblings:
            bits += sha256.bytes_stream(sib)
        return self.instance.weights(bits)
