"""Groth16 setup / prove / verify (host tier).

The port's own copy of `zksnark_tpu/groth16/protocol.py`: the `SigmaG1`
/ `SigmaG2` / `Proof` containers, the host `setup` and `prove` over a
dense-polynomial `QAP`, and the two verifiers, all generic over a backend
(`backend.BN254Backend`, `backend.Z251Backend`).  The toxic waste
(alpha, beta, gamma, delta, x) and the blinding (r, s) can be pinned, or
drawn from an `rng` with the JAX package's draws, so both packages make
the same CRS and proof.  The device prover (`prover.py`) computes the
same A, B, C with NTTs and MSMs on the card; this tier is its oracle.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..poly import dense
from .qap import QAP


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


def setup(
    backend,
    qap: QAP,
    trapdoor: Optional[Tuple[int, int, int, int, int]] = None,
    rng: Optional[random.Random] = None,
) -> Tuple[SigmaG1, SigmaG2]:
    """CRS generation.  Without a trapdoor its five values are drawn by
    `backend.field.random_elem(rng)`."""
    f = backend.field
    if trapdoor is None:
        trapdoor = tuple(f.random_elem(rng) for _ in range(5))
    alpha, beta, gamma, delta, x = (f.from_int(t) for t in trapdoor)

    xi: List[int] = []
    acc = f.one()
    for _ in range(qap.degree):
        xi.append(acc)
        acc = f.mul(acc, x)

    gamma_inv = f.inv(gamma)
    delta_inv = f.inv(delta)

    def combined(i: int) -> int:
        ui = dense.evaluate(f, qap.u[i], x)
        vi = dense.evaluate(f, qap.v[i], x)
        wi = dense.evaluate(f, qap.w[i], x)
        return f.add(f.add(f.mul(beta, ui), f.mul(alpha, vi)), wi)

    sum_gamma = [
        backend.encrypt_g1(f.mul(combined(i), gamma_inv))
        for i in range(min(qap.input + 1, qap.num_wires))
    ]
    sum_delta = [
        backend.encrypt_g1(f.mul(combined(i), delta_inv))
        for i in range(qap.input + 1, qap.num_wires)
    ]
    t_x = dense.evaluate(f, qap.t, x)
    xi_t = [
        backend.encrypt_g1(f.mul(f.mul(p, t_x), delta_inv)) for p in xi[:-1]
    ]

    sigmag1 = SigmaG1(
        alpha=backend.encrypt_g1(alpha),
        beta=backend.encrypt_g1(beta),
        delta=backend.encrypt_g1(delta),
        xi=[backend.encrypt_g1(p) for p in xi],
        sum_gamma=sum_gamma,
        sum_delta=sum_delta,
        xi_t=xi_t,
    )
    sigmag2 = SigmaG2(
        beta=backend.encrypt_g2(beta),
        gamma=backend.encrypt_g2(gamma),
        delta=backend.encrypt_g2(delta),
        xi=[backend.encrypt_g2(p) for p in xi],
    )
    return sigmag1, sigmag2


def prove(
    backend,
    qap: QAP,
    crs: Tuple[SigmaG1, SigmaG2],
    weights: Sequence[int],
    blinding: Optional[Tuple[int, int]] = None,
    rng: Optional[random.Random] = None,
) -> Proof:
    """The prover.  Weights are ordered [unity = 1, the verify wires in
    declaration order, the other wires in first-appearance order].
    Without a blinding, (r, s) are drawn by `backend.field.random_elem`."""
    f = backend.field
    sigmag1, sigmag2 = crs
    if blinding is None:
        blinding = (f.random_elem(rng), f.random_elem(rng))
    r, s = (f.from_int(b) for b in blinding)

    def weighted_sum(rows: List[dense.Poly]) -> dense.Poly:
        acc: dense.Poly = [0]
        for p, a in zip(rows, weights):
            acc = dense.add(f, acc, dense.scalar_mul(f, p, f.from_int(a)))
        return acc

    u_sum = weighted_sum(qap.u)
    v_sum = weighted_sum(qap.v)
    w_sum = weighted_sum(qap.w)

    def msm_g1(coeffs: Sequence[int], points: Sequence[object]):
        acc = backend.g1_zero()
        for c, pt in zip(coeffs, points):
            acc = backend.g1_add(acc, backend.exp_g1(c, pt))
        return acc

    def msm_g2(coeffs: Sequence[int], points: Sequence[object]):
        acc = backend.g2_zero()
        for c, pt in zip(coeffs, points):
            acc = backend.g2_add(acc, backend.exp_g2(c, pt))
        return acc

    a_g1 = msm_g1(u_sum, sigmag1.xi)
    b_g1 = msm_g1(v_sum, sigmag1.xi)
    b_g2 = msm_g2(v_sum, sigmag2.xi)

    a = backend.g1_add(
        backend.g1_add(a_g1, sigmag1.alpha), backend.exp_g1(r, sigmag1.delta))
    b = backend.g2_add(
        backend.g2_add(b_g2, sigmag2.beta), backend.exp_g2(s, sigmag2.delta))

    # h = (u_sum * v_sum - w_sum) / t, the quotient only: a bad witness
    # leaves a remainder and gives a proof that fails verification
    h = dense.div(
        f, dense.sub(f, dense.mul(f, u_sum, v_sum), w_sum), qap.t)

    c = msm_g1(h, sigmag1.xi_t)
    c = backend.g1_add(
        c, msm_g1(list(weights)[qap.input + 1:], sigmag1.sum_delta))
    c = backend.g1_add(c, backend.exp_g1(s, a))
    c = backend.g1_add(
        c,
        backend.exp_g1(
            r,
            backend.g1_add(
                backend.g1_add(sigmag1.beta, b_g1),
                backend.exp_g1(s, sigmag1.delta),
            ),
        ),
    )
    c = backend.g1_sub(c, backend.exp_g1(f.mul(r, s), sigmag1.delta))
    return Proof(a=a, b=b, c=c)


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
    the public inputs prefixed by 1 for the unity wire; GT "*" is the
    backend's `gt_add` (Fq12 product for BN254, field addition for the
    Z251 mock)."""
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
