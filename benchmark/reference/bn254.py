"""BN254 (alt_bn128) in plain Python: the groups a Groth16 proof lives in.

y^2 = x^3 + 3 over Fq (G1) and y^2 = x^3 + 3/(9 + u) over Fq2 = Fq[u]/(u^2 + 1)
(G2, the sextic twist), with the standard generators (EIP-196/197).  Scalar
multiplication runs in Jacobian coordinates and returns affine tuples:
G1 (x, y), G2 ((x0, x1), (y0, y1)), None for the point at infinity: the
form the prover's proofs take.
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1 = (1, 2)
G2 = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
       11559732032986387107991004021392285783925812861821192530917403151452391805634),
      (8495653923123431417604973247489272438418190587263600148770280649306958101930,
       4082367875863433681332203403145435568316851327593401208105741076214120093531))

# The prover encrypts its CRS against the scaled generators 69 * G1 and
# 96 * G2 (the convention of the system under test, which the proofs carry).
G1_SCALE = 69
G2_SCALE = 96


class Fq:
    """Arithmetic of the base field on plain ints."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)

    @staticmethod
    def is_zero(a):
        return a == 0


class Fq2:
    """Arithmetic of Fq[u]/(u^2 + 1) on pairs of ints."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q,
                (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
        return (a[0] * n % Q, -a[1] * n % Q)

    @staticmethod
    def is_zero(a):
        return a == (0, 0)


def _double(F, p):
    """dbl-2009-l (a = 0) on Jacobian (X, Y, Z)."""
    x, y, z = p
    if F.is_zero(z):
        return p
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul(b, b)
    t = F.add(x, b)
    d = F.sub(F.mul(t, t), F.add(a, c))
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    f = F.mul(e, e)
    x3 = F.sub(f, F.add(d, d))
    c8 = F.add(c, c)
    c8 = F.add(c8, c8)
    c8 = F.add(c8, c8)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    yz = F.mul(y, z)
    return (x3, y3, F.add(yz, yz))


def _add_affine(F, p, q):
    """Jacobian p plus affine q (not infinity), the general cases included."""
    x1, y1, z1 = p
    if F.is_zero(z1):
        return (q[0], q[1], F.one)
    z1z1 = F.mul(z1, z1)
    u2 = F.mul(q[0], z1z1)
    s2 = F.mul(q[1], F.mul(z1, z1z1))
    h = F.sub(u2, x1)
    r = F.sub(s2, y1)
    if F.is_zero(h):
        if F.is_zero(r):
            return _double(F, p)
        return (F.one, F.one, F.zero)
    hh = F.mul(h, h)
    hhh = F.mul(h, hh)
    v = F.mul(x1, hh)
    x3 = F.sub(F.sub(F.mul(r, r), hhh), F.add(v, v))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.mul(y1, hhh))
    return (x3, y3, F.mul(z1, h))


def _to_affine(F, p):
    x, y, z = p
    if F.is_zero(z):
        return None
    zi = F.inv(z)
    zi2 = F.mul(zi, zi)
    return (F.mul(x, zi2), F.mul(y, F.mul(zi, zi2)))


def _scalar_mul(F, base, k: int):
    k %= R
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:] if k else "":
        acc = _double(F, acc)
        if bit == "1":
            acc = _add_affine(F, acc, base)
    return _to_affine(F, acc)


def g1_mul(k: int):
    """k * G1 as an affine G1 point (None for infinity)."""
    return _scalar_mul(Fq, G1, k)


def g2_mul(k: int):
    """k * G2 as an affine G2 point (None for infinity)."""
    return _scalar_mul(Fq2, G2, k)
