"""End-to-end zero-knowledge proof of a Keccak-256 preimage, on the card.

The whole stack in one script: circuit builder (in-circuit Keccak-256) ->
CircuitInstance -> R1CS -> radix-2 device QAP -> device setup -> device
prove (NTT + MSM kernels) -> host pairing verify.  The prover shows
knowledge of a preimage whose Keccak-256 digest (followed by the zero
outputs of the preimage bits' bit checkers) is the public input.  A 4-byte
preimage gives 232,016 gates, so a domain of n = 2^18.

Usage:  python3 -m zksnark_tpu_torch.examples.keccak_proof [preimage-bytes]
        (default 4 bytes).  Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time

from ..builder.circuit import Circuit
from ..builder.instance import CircuitInstance
from ..builder.words import flatten_word8
from ..field.host import FR
from ..utils.keccak_host import keccak256

TRAPDOOR = (101, 202, 303, 404, 505)
BLINDING = (606, 707)


def preimage_of(n_bytes: int):
    return [(37 * i + 11) & 0xFF for i in range(n_bytes)]


def bits_of(data):
    """Bytes -> little-endian bits, eight per byte."""
    return [(byte >> i) & 1 for byte in data for i in range(8)]


def build(n_bytes: int):
    """The circuit of Keccak-256 over `n_bytes` private input bytes, bound
    to its verify wires (digest bits, then one bit checker per input bit).
    Returns (circuit, instance, number of bit checkers)."""
    c = Circuit(FR)
    inp = c.new_word8_vec(n_bytes)
    hash_words = c.keccak256(inp)
    bit_checkers = c.bit_check(flatten_word8(inp))
    verify_wires = flatten_word8(hash_words) + bit_checkers
    inst = CircuitInstance(c, verify_wires, flatten_word8(inp),
                           lambda sc: FR.from_int(sc + 1))
    return c, inst, len(bit_checkers)


def public_inputs(digest: bytes, n_checkers: int):
    """The verify-wire values: the digest's bits, then zero checkers."""
    return bits_of(digest) + [0] * n_checkers


def main(argv=None) -> int:
    from .._device import resolve_device
    from ..groth16 import protocol, prover
    from ..groth16.backend import BN254Backend

    try:
        dev = resolve_device()
    except RuntimeError as e:
        print(f"keccak_proof: {e}", file=sys.stderr)
        return 2
    argv = sys.argv[1:] if argv is None else argv
    n_bytes = int(argv[0]) if argv else 4
    preimage = preimage_of(n_bytes)
    digest = keccak256(preimage)
    print(f"preimage: {bytes(preimage).hex()}  digest: {digest.hex()}")

    t0 = time.time()
    c, inst, n_checkers = build(n_bytes)
    print(f"circuit: {c.num_sub_circuits()} gates, {c.num_wires()} wires "
          f"({time.time() - t0:.1f}s to build)")

    t0 = time.time()
    weights = inst.weights(bits_of(preimage))
    print(f"witness: {len(weights)} wires ({time.time() - t0:.1f}s)")

    t0 = time.time()
    dqap = prover.compile_r1cs(inst.r1cs(), device=dev)
    print(f"compiled: domain n={dqap.n} ({time.time() - t0:.1f}s)")

    t0 = time.time()
    dcrs = prover.device_setup(dqap, trapdoor=TRAPDOOR)
    print(f"device setup: {time.time() - t0:.1f}s")

    t0 = time.time()
    proof = prover.device_prove(dqap, dcrs, weights, blinding=BLINDING)
    print(f"device prove: {time.time() - t0:.1f}s")

    public = public_inputs(digest, n_checkers)
    be = BN254Backend()
    crs = (dcrs.sigmag1, dcrs.sigmag2)
    t0 = time.time()
    ok = protocol.verify_fast(be, crs, public, proof)
    print(f"verify: {'ACCEPT' if ok else 'REJECT'} ({time.time() - t0:.2f}s)")

    bad = list(public)
    bad[0] ^= 1
    rej = protocol.verify_fast(be, crs, bad, proof)
    print(f"tampered digest: {'ACCEPT (BUG!)' if rej else 'REJECT'}")
    return 0 if ok and not rej else 1


if __name__ == "__main__":
    sys.exit(main())
