"""Host prime fields over plain Python ints.

The port's own copy of the exact-semantics tier of `zksnark_tpu/field/
host.py`: the frontends, the circuit builder, the witness and the host
Groth16 protocol run on it.  Elements are canonical residues in
``range(p)`` (plain ints, no wrapper class); a `PrimeField` instance
carries the operations.  Besides the ring operations it has extended
Euclid, CRT, the infinite powers generator and the naive O(n^2) DFT /
IDFT (a test oracle for the NTT).  The batched arithmetic on the card
lives in `field.limb`.
"""

from __future__ import annotations

import random
from typing import Iterable, List, Optional, Sequence

from . import params


def ext_euc_alg(a: int, b: int):
    """Extended Euclid: (g, s, t) with g = gcd(a, b) = s*a + t*b."""
    r0, r1 = a, b
    s0, s1 = 1, 0
    t0, t1 = 0, 1
    while r1 != 0:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        s0, s1 = s1, s0 - q * s1
        t0, t1 = t1, t0 - q * t1
    return r0, s0, t0


def chinese_remainder(rems: Sequence[int], moduli: Sequence[int]) -> int:
    """CRT combination of `rems` modulo pairwise coprime `moduli`.  The
    result is defined only modulo prod(moduli) and may be negative:
    callers normalize."""
    prod = 1
    for m in moduli:
        prod *= m
    acc = 0
    for rem, m in zip(rems, moduli):
        x = prod // m
        _, inv, _ = ext_euc_alg(x, m)
        acc += inv * x * rem
    return acc


class PrimeField:
    """A prime field GF(p) acting on canonical int residues."""

    def __init__(self, p: int, name: str = "GF(p)"):
        self.p = p
        self.name = name

    def zero(self) -> int:
        return 0

    def one(self) -> int:
        return 1

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError(f"{self.name}: inverse of zero")
        return pow(a, self.p - 2, self.p)

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def from_int(self, n: int) -> int:
        return n % self.p

    def parse(self, s: str) -> Optional[int]:
        """Parse a decimal literal, reduced mod p; None on failure
        (subclasses may restrict, see Z251Field.parse)."""
        try:
            return int(s, 10) % self.p
        except ValueError:
            return None

    def random_elem(self, rng: Optional[random.Random] = None) -> int:
        """Uniform nonzero element: `rng.randrange(1, p)` (the module
        `random` when no rng is given), the JAX package's draw, so one
        seeded `random.Random` gives both packages the same values."""
        r = rng or random
        return r.randrange(1, self.p)

    def powers(self, x: int):
        """Infinite generator 1, x, x^2, ..."""
        acc = 1
        while True:
            yield acc
            acc = self.mul(acc, x)

    def dft(self, seq: Sequence[int], root: int) -> List[int]:
        """Naive O(n^2) DFT given a root of unity of order len(seq) (a
        test oracle)."""
        out = []
        ri = 1
        for _ in range(len(seq)):
            acc, rj = 0, 1
            for a in seq:
                acc = (acc + a * rj) % self.p
                rj = (rj * ri) % self.p
            out.append(acc)
            ri = (ri * root) % self.p
        return out

    def idft(self, seq: Sequence[int], root: int) -> List[int]:
        """Inverse of `dft`."""
        n_inv = self.inv(len(seq) % self.p)
        return [self.mul(v, n_inv) for v in self.dft(seq, self.inv(root))]

    def __repr__(self):
        return f"PrimeField({self.name})"


class Z251Field(PrimeField):
    """GF(251), the cheap test field."""

    def __init__(self):
        super().__init__(251, "Z251")

    def parse(self, s: str) -> Optional[int]:
        # literals >= 251 are a parse error, not reduced
        try:
            n = int(s, 10)
        except ValueError:
            return None
        if n < 0 or n >= 251:
            return None
        return n


Z251 = Z251Field()
FR = PrimeField(params.R, "BN254::Fr")
FQ = PrimeField(params.Q, "BN254::Fq")


# Bit <-> field codecs: bits are little-endian per number, and each number
# contributes exactly `width` bits.

def to_field_bits(field: PrimeField, nums: Iterable[int], width: int) -> List[int]:
    out: List[int] = []
    for num in nums:
        for i in range(width):
            out.append(field.one() if (num >> i) & 1 else field.zero())
    return out


def from_field_bits(field: PrimeField, bits: Sequence[int], width: int) -> List[int]:
    if len(bits) % width != 0:
        raise ValueError("bit stream length must be a multiple of width")
    out = []
    for off in range(0, len(bits), width):
        acc = 0
        for i, b in enumerate(bits[off:off + width]):
            if b == field.one():
                acc ^= 1 << i
            elif b != field.zero():
                raise ValueError(
                    "from_field_bits: element is neither zero() nor one()")
        out.append(acc)
    return out
