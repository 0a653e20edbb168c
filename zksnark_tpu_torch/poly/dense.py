"""Dense coefficient-domain polynomials over a host `PrimeField`.

The port's own copy of `zksnark_tpu/poly/dense.py`: the exact tier that
the host QAP (`groth16/qap.py`) and the host Groth16 protocol run on, and
the oracle of the NTT's `poly_mul` (`ops/ntt.py`).

A polynomial is a plain list of int coefficients, index = power of x.
Trailing zeros are allowed (degree ignores them).  Edge cases kept from
the reference semantics: a zero divisor raises, a divisor of higher
degree than the dividend gives ([0], [0]), and `div` drops the remainder.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.host import PrimeField

Poly = List[int]


def degree(poly: Sequence[int]) -> int:
    """Highest non-zero power; 0 for the zero or empty polynomial."""
    d = len(poly)
    while d > 0 and poly[d - 1] == 0:
        d -= 1
    return d - 1 if d > 0 else 0


def remove_leading_zeros(poly: Sequence[int]) -> Poly:
    d = len(poly)
    while d > 0 and poly[d - 1] == 0:
        d -= 1
    return list(poly[:d])


def evaluate(field: PrimeField, poly: Sequence[int], x: int) -> int:
    """Horner evaluation."""
    acc = 0
    for c in reversed(poly):
        acc = (acc * x + c) % field.p
    return acc


def add(field: PrimeField, a: Sequence[int], b: Sequence[int]) -> Poly:
    """Zip-with-zero-padding addition; the result has max(len(a), len(b))
    coefficients (not trimmed)."""
    n = max(len(a), len(b))
    return [
        ((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % field.p
        for i in range(n)
    ]


def neg(field: PrimeField, a: Sequence[int]) -> Poly:
    return [(-c) % field.p for c in a]


def sub(field: PrimeField, a: Sequence[int], b: Sequence[int]) -> Poly:
    return add(field, a, neg(field, b))


def scalar_mul(field: PrimeField, a: Sequence[int], s: int) -> Poly:
    return [(c * s) % field.p for c in a]


def mul(field: PrimeField, a: Sequence[int], b: Sequence[int]) -> Poly:
    """Schoolbook convolution after trimming: degree(a) + degree(b) + 1
    coefficients, an empty or zero input counting as degree 0."""
    ta, tb = remove_leading_zeros(a), remove_leading_zeros(b)
    da = len(ta) - 1 if ta else 0
    db = len(tb) - 1 if tb else 0
    out = [0] * (da + db + 1)
    for i, ca in enumerate(ta):
        if ca == 0:
            continue
        for j, cb in enumerate(tb):
            out[i + j] = (out[i + j] + ca * cb) % field.p
    return out


def polynomial_division(
    field: PrimeField, poly: Sequence[int], divisor: Sequence[int]
) -> Tuple[Poly, Poly]:
    """Long division -> (quotient, remainder).  A zero divisor raises;
    deg(divisor) > deg(poly) returns ([0], [0])."""
    if not any(c % field.p != 0 for c in divisor):
        raise ZeroDivisionError("Dividend must be non-zero")
    if degree(divisor) > degree(poly):
        return [0], [0]

    r = remove_leading_zeros(poly)
    d_poly = remove_leading_zeros(divisor)
    d = len(d_poly) - 1
    c_inv = field.inv(d_poly[-1])
    q = [0] * ((len(r) - 1 if r else 0) - d + 1)

    while len(r) - 1 >= d and r:
        s = (r[-1] * c_inv) % field.p
        q[len(r) - 1 - d] = s
        for k in range(d + 1):
            r[len(r) - 1 - k] = (r[len(r) - 1 - k] - s * d_poly[d - k]) % field.p
        r = remove_leading_zeros(r)

    return q, (r if r else [0])


def div(field: PrimeField, a: Sequence[int], b: Sequence[int]) -> Poly:
    """The quotient only: the remainder is dropped, so an unsatisfied
    witness gives a proof that fails verification rather than an error
    (use `polynomial_division` to see the remainder)."""
    return polynomial_division(field, a, b)[0]


def lagrange_basis(field: PrimeField, roots: Sequence[int], x: int) -> Poly:
    """Product over roots r != x of (X - r) / (x - r)."""
    acc: Poly = [1]
    for m in roots:
        if m == x:
            continue
        scale = field.inv((x - m) % field.p)
        acc = scalar_mul(field, mul(field, acc, [(-m) % field.p, 1]), scale)
    return acc


def interpolate(
    field: PrimeField, roots: Sequence[int], points: Sequence[Tuple[int, int]]
) -> Poly:
    """Sum of y * lagrange_basis(roots, x) over the sparse (x, y) points;
    no points give the zero polynomial [0]."""
    acc: Poly = [0]
    for x, y in points:
        acc = add(field, acc, scalar_mul(field, lagrange_basis(field, roots, x), y))
    return acc


def root_poly(field: PrimeField, roots: Sequence[int]) -> Poly:
    """Vanishing polynomial prod (X - r)."""
    acc: Poly = [1]
    for r in roots:
        acc = mul(field, acc, [(-r) % field.p, 1])
    return acc
