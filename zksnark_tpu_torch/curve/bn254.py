"""BN254 (alt_bn128) curve arithmetic and the optimal-ate pairing — host
tier, in pure Python.

The port's own copy of `zksnark_tpu/curve/bn254.py` (the port imports
nothing of the JAX package): G1 over Fq, G2 over Fq2 on the sextic twist,
and the optimal-ate pairing e: G1 x G2 -> Fq12.  Setup uses it for the
generators, the comb tables and the small sigma parts, the prover for the
final proof assembly, and verify for the pairings.

Tower:

    Fq2  = Fq[u] / (u^2 + 1)                elements (a, b) = a + b*u
    Fq12 = Fq2[w] / (w^6 - xi), xi = 9 + u  elements: 6-tuple of Fq2

The Miller loop runs affine on the twist over the bits of 6u+2, followed by
the two Frobenius correction lines; the final exponentiation does the easy
part with Frobenius maps and the hard part by square-and-multiply.

Points are affine tuples: G1 = (x, y) ints, G2 = ((x0,x1), (y0,y1)); the
identity is None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..field.params import (
    BN_SIX_U_PLUS_2, G1_GEN, G2_GEN_X, G2_GEN_Y, Q, R, XI,
)

Fq2 = Tuple[int, int]
Fq12 = Tuple[Fq2, Fq2, Fq2, Fq2, Fq2, Fq2]
G1Point = Optional[Tuple[int, int]]
G2Point = Optional[Tuple[Fq2, Fq2]]

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

FQ2_ZERO: Fq2 = (0, 0)
FQ2_ONE: Fq2 = (1, 0)


def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a: Fq2) -> Fq2:
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_scalar(a: Fq2, k: int) -> Fq2:
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def fq2_square(a: Fq2) -> Fq2:
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t = (a[0] + a[1]) * (a[0] - a[1])
    return (t % Q, (2 * a[0] * a[1]) % Q)


def fq2_conj(a: Fq2) -> Fq2:
    return (a[0], (-a[1]) % Q)


def fq2_inv(a: Fq2) -> Fq2:
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    if norm == 0:
        raise ZeroDivisionError("Fq2 inverse of zero")
    n_inv = pow(norm, Q - 2, Q)
    return ((a[0] * n_inv) % Q, ((-a[1]) * n_inv) % Q)


def fq2_pow(a: Fq2, e: int) -> Fq2:
    acc = FQ2_ONE
    base = a
    while e:
        if e & 1:
            acc = fq2_mul(acc, base)
        base = fq2_square(base)
        e >>= 1
    return acc


# ---------------------------------------------------------------------------
# Fq12 = Fq2[w] / (w^6 - xi)
# ---------------------------------------------------------------------------

FQ12_ONE: Fq12 = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ12_ZERO: Fq12 = (FQ2_ZERO,) * 6


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    # schoolbook polynomial multiply, reduce w^6 -> xi
    prod: List[Fq2] = [FQ2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == FQ2_ZERO:
            continue
        for j in range(6):
            if b[j] == FQ2_ZERO:
                continue
            prod[i + j] = fq2_add(prod[i + j], fq2_mul(ai, b[j]))
    out = prod[:6]
    for k in range(6, 11):
        out[k - 6] = fq2_add(out[k - 6], fq2_mul(prod[k], XI))
    return tuple(out)


def fq12_square(a: Fq12) -> Fq12:
    return fq12_mul(a, a)


def fq12_conj(a: Fq12) -> Fq12:
    """Conjugation a -> a^(q^6): negates odd w-powers (w^(q^6) = -w)."""
    return (a[0], fq2_neg(a[1]), a[2], fq2_neg(a[3]), a[4], fq2_neg(a[5]))


def fq12_inv(a: Fq12) -> Fq12:
    """Inverse via the tower Fq12 = Fq6[w2-adic]... here: generic by solving
    with the resultant trick — a * conj_tower products.  We use the simple
    approach: treat Fq12 as Fq6[j]/(j^2 - v) is unavailable in this basis,
    so invert by linear algebra over the w-basis using Gaussian elimination
    on the multiplication matrix.  Cost is irrelevant host-side."""
    # Build the 12x12 matrix over Fq of multiplication by a, solve M x = e0.
    # Basis: 1, u, w, uw, w^2, uw^2, ..., w^5, uw^5.
    cols = []
    for i in range(6):
        for part in range(2):
            basis: List[Fq2] = [FQ2_ZERO] * 6
            basis[i] = (1, 0) if part == 0 else (0, 1)
            col = fq12_mul(a, tuple(basis))
            flat = []
            for c in col:
                flat.extend(c)
            cols.append(flat)
    n = 12
    m = [[cols[j][i] % Q for j in range(n)] for i in range(n)]
    rhs = [1] + [0] * 11
    # Gaussian elimination mod Q
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r][col] % Q != 0)
        m[col], m[piv] = m[piv], m[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = pow(m[col][col], Q - 2, Q)
        m[col] = [(x * inv) % Q for x in m[col]]
        rhs[col] = (rhs[col] * inv) % Q
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [(x - f * y) % Q for x, y in zip(m[r], m[col])]
                rhs[r] = (rhs[r] - f * rhs[col]) % Q
    out = []
    for i in range(6):
        out.append((rhs[2 * i], rhs[2 * i + 1]))
    return tuple(out)


def fq12_pow(a: Fq12, e: int) -> Fq12:
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    acc = FQ12_ONE
    base = a
    while e:
        if e & 1:
            acc = fq12_mul(acc, base)
        base = fq12_mul(base, base)
        e >>= 1
    return acc


# Frobenius constants: w^q = gamma1 * w with gamma1 = xi^((q-1)/6), and
# gamma_i = xi^(i(q-1)/6) for coefficient i.
assert (Q - 1) % 6 == 0
_GAMMA1: List[Fq2] = [fq2_pow(XI, i * (Q - 1) // 6) for i in range(6)]


def fq12_frobenius(a: Fq12) -> Fq12:
    """a -> a^q in the w-basis: conj each Fq2 coeff, scale by gamma_i."""
    return tuple(
        fq2_mul(fq2_conj(a[i]), _GAMMA1[i]) for i in range(6)
    )


def fq12_frobenius_n(a: Fq12, n: int) -> Fq12:
    for _ in range(n):
        a = fq12_frobenius(a)
    return a


# ---------------------------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fq
# ---------------------------------------------------------------------------

G1_INF: G1Point = None
G1_GEN_PT: G1Point = G1_GEN


def g1_is_on_curve(p: G1Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0


def g1_neg(p: G1Point) -> G1Point:
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_add(p: G1Point, q: G1Point) -> G1Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_double(p: G1Point) -> G1Point:
    return g1_add(p, p)


def g1_scalar_mul(p: G1Point, k: int) -> G1Point:
    k %= R
    acc: G1Point = None
    add = p
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# G2: y^2 = x^3 + 3/xi over Fq2 (sextic D-twist)
# ---------------------------------------------------------------------------

G2_B: Fq2 = fq2_mul((3, 0), fq2_inv(XI))
G2_INF: G2Point = None
G2_GEN: G2Point = (G2_GEN_X, G2_GEN_Y)


def g2_is_on_curve(p: G2Point) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = fq2_square(y)
    rhs = fq2_add(fq2_mul(fq2_square(x), x), G2_B)
    return lhs == rhs


def g2_neg(p: G2Point) -> G2Point:
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


def g2_add(p: G2Point, q: G2Point) -> G2Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(
            fq2_scalar(fq2_square(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_square(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(p: G2Point) -> G2Point:
    return g2_add(p, p)


def g2_scalar_mul(p: G2Point, k: int) -> G2Point:
    k %= R
    acc: G2Point = None
    add = p
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Optimal-ate pairing
# ---------------------------------------------------------------------------

def _line(T: G2Point, Qp: G2Point, P: Tuple[int, int]) -> Tuple[G2Point, Fq12]:
    """One Miller step: the line through Psi(T), Psi(Qp) (tangent when
    T == Qp) evaluated at P, plus the new point T + Qp on the twist.

    l(P) = yP + (-lambda xP) w + (lambda xT - yT) w^3  (coeffs in Fq2).
    For a vertical line (T + Qp = O): l(P) = xP - xT  ... embedded as
    (xP - xT_fq2) in coefficient w^2 position after untwist:
        x - X_T = xP - xT w^2  -> coefficients 0 and 2.
    """
    xP, yP = P
    x1, y1 = T
    x2, y2 = Qp
    if T == Qp:
        lam = fq2_mul(fq2_scalar(fq2_square(x1), 3),
                      fq2_inv(fq2_scalar(y1, 2)))
    elif x1 == x2:
        # vertical line x - x1 (T = -Qp): value xP - x1 w^2
        coeffs: List[Fq2] = [FQ2_ZERO] * 6
        coeffs[0] = (xP % Q, 0)
        coeffs[2] = fq2_neg(x1)
        return None, tuple(coeffs)
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))

    x3 = fq2_sub(fq2_sub(fq2_square(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)

    coeffs = [FQ2_ZERO] * 6
    coeffs[0] = (yP % Q, 0)
    coeffs[1] = fq2_neg(fq2_scalar(lam, xP))
    coeffs[3] = fq2_sub(fq2_mul(lam, x1), y1)
    return (x3, y3), tuple(coeffs)


def _g2_frobenius(p: G2Point) -> G2Point:
    """pi_q on the twist: (x, y) -> (conj(x) gamma_2, conj(y) gamma_3)."""
    if p is None:
        return None
    x, y = p
    return (fq2_mul(fq2_conj(x), _GAMMA1[2]), fq2_mul(fq2_conj(y), _GAMMA1[3]))


def miller_loop(P: G1Point, Qp: G2Point) -> Fq12:
    """Optimal-ate Miller function f_{6u+2,Q}(P) including the two
    Frobenius correction lines (no final exponentiation)."""
    if P is None or Qp is None:
        return FQ12_ONE
    f = FQ12_ONE
    T = Qp
    bits = bin(BN_SIX_U_PLUS_2)[3:]  # skip the leading 1
    for b in bits:
        T, l = _line(T, T, P)
        f = fq12_mul(fq12_mul(f, f), l)
        if b == "1":
            T, l = _line(T, Qp, P)
            f = fq12_mul(f, l)

    q1 = _g2_frobenius(Qp)
    q2 = g2_neg(_g2_frobenius(q1))
    T, l = _line(T, q1, P)
    f = fq12_mul(f, l)
    _, l = _line(T, q2, P)
    f = fq12_mul(f, l)
    return f


# hard-part exponent of the final exponentiation
_HARD_EXP = (Q**4 - Q**2 + 1) // R
assert (Q**4 - Q**2 + 1) % R == 0


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12-1)/r): easy part with Frobenius/conjugation, hard part by
    direct square-and-multiply (correct-first; chain-optimized version is a
    drop-in replacement)."""
    # easy: f^(q^6 - 1)
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    # easy: ^(q^2 + 1)
    f = fq12_mul(fq12_frobenius_n(f, 2), f)
    # hard: ^((q^4 - q^2 + 1)/r)
    return fq12_pow(f, _HARD_EXP)


def pairing(P: G1Point, Qp: G2Point) -> Fq12:
    """e(P, Q) in GT ⊂ Fq12 (identity for either input at infinity)."""
    return final_exponentiation(miller_loop(P, Qp))


def multi_pairing(pairs) -> Fq12:
    """prod e(P_i, Q_i) with a single shared final exponentiation — the fast
    path for verification equations."""
    f = FQ12_ONE
    for P, Qp in pairs:
        f = fq12_mul(f, miller_loop(P, Qp))
    return final_exponentiation(f)
