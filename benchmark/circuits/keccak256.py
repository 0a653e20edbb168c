"""Knowledge of a preimage of a Keccak-256 digest, built by the prover's
circuit builder as `zksnark_tpu_torch/examples/keccak_proof.py:build`
builds it: the in-circuit Keccak-256 of `preimage_bytes` private bytes,
its verify wires the digest's bits and then one bit checker per preimage
bit.  A statement is a preimage; its witness comes from the builder's
`CircuitInstance.weights` on the preimage's bits.
"""

from __future__ import annotations

from zksnark_tpu_torch.builder.circuit import Circuit as Builder
from zksnark_tpu_torch.builder.instance import CircuitInstance
from zksnark_tpu_torch.builder.words import flatten_word8
from zksnark_tpu_torch.field.host import FR


def statement(cfg: dict, rng) -> bytes:
    return bytes(rng.randrange(256) for _ in range(int(cfg["preimage_bytes"])))


class Circuit:
    def __init__(self, cfg: dict):
        self.n_bytes = int(cfg["preimage_bytes"])
        c = Builder(FR)
        inp = c.new_word8_vec(self.n_bytes)
        hash_words = c.keccak256(inp)
        checkers = c.bit_check(flatten_word8(inp))
        self.circuit = c
        self.instance = CircuitInstance(
            c, flatten_word8(hash_words) + checkers, flatten_word8(inp),
            lambda sc: FR.from_int(sc + 1))

    def r1cs(self):
        return self.instance.r1cs()

    def witness(self, preimage: bytes) -> list:
        # the builder memoizes wire values: a new statement starts from a
        # reset circuit
        self.circuit.reset()
        return self.instance.weights(
            [(byte >> i) & 1 for byte in preimage for i in range(8)])
