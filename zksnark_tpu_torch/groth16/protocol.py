"""Groth16 CRS parts, proofs and verification (host tier).

The port's own copy of the verifier half of `zksnark_tpu/groth16/
protocol.py`: the `SigmaG1` / `SigmaG2` / `Proof` containers and the two
verifiers, generic over a backend (`backend.BN254Backend`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass
class SigmaG1:
    """G1 part of the CRS."""
    alpha: object
    beta: object
    delta: object
    xi: List[object]
    sum_gamma: List[object]
    sum_delta: List[object]
    xi_t: List[object]


@dataclass
class SigmaG2:
    """G2 part of the CRS."""
    beta: object
    gamma: object
    delta: object
    xi: List[object]


@dataclass
class Proof:
    a: object
    b: object
    c: object


def _input_sum(backend, sigmag1: SigmaG1, inputs: Sequence[int]):
    f = backend.field
    sum_term = backend.g1_zero()
    coeffs = [f.one()] + [f.from_int(i) for i in inputs]
    for pt, a in zip(sigmag1.sum_gamma, coeffs):
        sum_term = backend.g1_add(sum_term, backend.exp_g1(a, pt))
    return sum_term


def verify(backend, crs: Tuple[SigmaG1, SigmaG2], inputs: Sequence[int],
           proof: Proof) -> bool:
    """Checks e(alpha, beta) * e(sum, gamma) * e(C, delta) == e(A, B), with
    the public inputs prefixed by 1 for the unity wire."""
    sigmag1, sigmag2 = crs
    sum_term = _input_sum(backend, sigmag1, inputs)
    lhs = backend.gt_add(
        backend.gt_add(
            backend.pairing(sigmag1.alpha, sigmag2.beta),
            backend.pairing(sum_term, sigmag2.gamma),
        ),
        backend.pairing(proof.c, sigmag2.delta),
    )
    rhs = backend.pairing(proof.a, proof.b)
    return backend.gt_eq(lhs, rhs)


def verify_fast(backend, crs: Tuple[SigmaG1, SigmaG2],
                inputs: Sequence[int], proof: Proof) -> bool:
    """The same check as one product of pairings with a single final
    exponentiation: e(alpha,beta) e(sum,gamma) e(C,delta) e(-A,B) == 1."""
    sigmag1, sigmag2 = crs
    sum_term = _input_sum(backend, sigmag1, inputs)
    neg_a = backend.g1_sub(backend.g1_zero(), proof.a)
    return backend.pairing_check([
        (sigmag1.alpha, sigmag2.beta),
        (sum_term, sigmag2.gamma),
        (proof.c, sigmag2.delta),
        (neg_a, proof.b),
    ])
