"""The Groth16 proof that a statement must get, worked out from the
trapdoor and the blinding.

The benchmark draws the trapdoor (alpha, beta, gamma, delta, x) and each
proof's blinding (r, s) and hands them to the prover, so every scalar a
proof encodes is known here:

    a = alpha + U(x) + r delta
    b = beta + V(x) + s delta
    c = (K + U(x) V(x) - W(x)) / delta + s a + r b - r s delta

with U(x) = sum_g L_g(x) u_g over the gates g, u_g the left linear
combination of gate g on the witness (V, W: right, output), and
K = beta (U - U_pub) + alpha (V - V_pub) + (W - W_pub), where the _pub
parts take only the public wires (the unity wire and the statement's
verify wires).  The proof is A = a P1, B = b P2, C = c P1 over the prover's
scaled generators P1 = 69 G1, P2 = 96 G2.  A proof equal to these three
points is the one Groth16 defines for this statement, this witness and
this CRS; U V - W = h t holds because the witness satisfies every gate.

L_g is the Lagrange basis of the gates' domain {omega^g}, n = 2^k the
smallest power of two >= the number of gates (k >= 1), omega the n-th
root of unity 5^((r - 1) / 2^28) raised to 2^(28 - k): the domain
convention of the system under test.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

from . import bn254

R = bn254.R
TWO_ADICITY = 28
GENERATOR = 5


class Sums(NamedTuple):
    """A statement's sums over the gates at x: U, V, W and their public
    parts."""

    u: int
    v: int
    w: int
    u_pub: int
    v_pub: int
    w_pub: int


def log_domain(n_gates: int) -> int:
    return max(1, (n_gates - 1).bit_length())


class Lagrange:
    """The Lagrange basis at x of the domain of `n_gates` gates, as
    L_g(x) = scale * e_g with e_g = 1 / (x omega^-g - 1) and
    scale = (x^n - 1) / n."""

    def __init__(self, x: int, n_gates: int):
        log_n = log_domain(n_gates)
        n = 1 << log_n
        omega = pow(pow(GENERATOR, (R - 1) >> TWO_ADICITY, R),
                    1 << (TWO_ADICITY - log_n), R)
        omega_inv = pow(omega, -1, R)
        x %= R
        if pow(x, n, R) == 1:
            raise ValueError("the trapdoor x lies on the domain")
        # d_g = x omega^-g - 1, inverted in one batch
        d, y = [0] * n_gates, x
        for g in range(n_gates):
            d[g] = (y - 1) % R
            y = y * omega_inv % R
        prefix, acc = [0] * n_gates, 1
        for g in range(n_gates):
            prefix[g] = acc
            acc = acc * d[g] % R
        inv = pow(acc, -1, R)
        e = d
        for g in range(n_gates - 1, -1, -1):
            e[g], inv = inv * prefix[g] % R, inv * d[g] % R
        self.e = e
        self.scale = (pow(x, n, R) - 1) * pow(n, -1, R) % R
        self.n = n

    def dot(self, values: Sequence[int]) -> int:
        """sum_g L_g(x) values[g] over the first len(values) gates."""
        return self.scale * (sum(map(int.__mul__, values, self.e)) % R) % R

    def at(self, g: int) -> int:
        return self.scale * self.e[g] % R


def scalars(sums: Sums, trapdoor: Sequence[int],
            blinding: Sequence[int]) -> Tuple[int, int, int]:
    alpha, beta, _gamma, delta, _x = (t % R for t in trapdoor)
    r, s = (b % R for b in blinding)
    a = (alpha + sums.u + r * delta) % R
    b = (beta + sums.v + s * delta) % R
    k = (beta * (sums.u - sums.u_pub) + alpha * (sums.v - sums.v_pub)
         + sums.w - sums.w_pub) % R
    c = ((k + sums.u * sums.v - sums.w) * pow(delta, -1, R)
         + s * a + r * b - r * s * delta) % R
    return a, b, c


def proof(sums: Sums, trapdoor: Sequence[int], blinding: Sequence[int]):
    """(A, B, C) as affine tuples."""
    a, b, c = scalars(sums, trapdoor, blinding)
    return (bn254.g1_mul(a * bn254.G1_SCALE),
            bn254.g2_mul(b * bn254.G2_SCALE),
            bn254.g1_mul(c * bn254.G1_SCALE))


def _affine(p) -> Optional[tuple]:
    """A proof element as plain nested int tuples (None for infinity)."""
    if p is None:
        return None
    return tuple(tuple(int(c) for c in v) if isinstance(v, (tuple, list))
                 else int(v) for v in p)


def same(got, want) -> bool:
    """Whether a prover's proof (anything with .a .b .c affine points)
    is the expected (A, B, C)."""
    try:
        return (_affine(got.a), _affine(got.b), _affine(got.c)) == want
    except (AttributeError, TypeError, ValueError):
        return False
