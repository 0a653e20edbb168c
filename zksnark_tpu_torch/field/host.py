"""Host prime fields over plain Python ints.

The port's own copy of the exact-semantics tier of `zksnark_tpu/field/
host.py`: the frontends, the circuit builder and the witness run on it.
Elements are canonical residues in ``range(p)`` (plain ints, no wrapper
class); a `PrimeField` instance carries the operations.  The batched
arithmetic on the card lives in `field.limb`.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from . import params


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
