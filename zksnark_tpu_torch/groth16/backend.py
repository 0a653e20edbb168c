"""Pairing backends of the Groth16 protocol (host tier).

The port's own copy of `zksnark_tpu/groth16/backend.py`:

- `Z251Backend`, the mock over GF(251): encryption is multiplication by
  69, pairing is field multiplication and GT "addition" is field
  addition.  CRS elements divide back to the toxic waste, and soundness
  statistics (~1/251 random-proof acceptance) can be measured cheaply.
- `BN254Backend`: encrypt_g1(x) = (69*G1)*x and encrypt_g2(x) =
  (96*G2)*x, GT elements are Fq12 values and GT "addition" is Fq12
  multiplication.
"""

from __future__ import annotations

import random
from typing import Optional

from ..curve import bn254 as _c
from ..field import params
from ..field.host import FR, PrimeField, Z251


class Z251Backend:
    """G1 = G2 = GT = Z251, encrypt = *69; the verification equation is
    alpha*beta + sum*gamma + C*delta == A*B over GF(251)."""

    name = "z251-mock"
    field: PrimeField = Z251

    def encrypt_g1(self, x: int) -> int:
        return (x * 69) % 251

    def encrypt_g2(self, x: int) -> int:
        return (x * 69) % 251

    def exp_g1(self, scalar: int, g1: int) -> int:
        return (scalar * g1) % 251

    def exp_g2(self, scalar: int, g2: int) -> int:
        return (scalar * g2) % 251

    def g1_zero(self) -> int:
        return 0

    def g2_zero(self) -> int:
        return 0

    def g1_add(self, a: int, b: int) -> int:
        return (a + b) % 251

    def g1_sub(self, a: int, b: int) -> int:
        return (a - b) % 251

    def g2_add(self, a: int, b: int) -> int:
        return (a + b) % 251

    def pairing(self, g1: int, g2: int) -> int:
        return (g1 * g2) % 251

    def gt_add(self, a: int, b: int) -> int:
        return (a + b) % 251

    def gt_eq(self, a: int, b: int) -> bool:
        return a == b

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == identity: the sum of the products is 0."""
        acc = 0
        for g1, g2 in pairs:
            acc = (acc + g1 * g2) % 251
        return acc == 0

    def random_g1(self, rng: Optional[random.Random] = None) -> int:
        return self.field.random_elem(rng)

    def random_g2(self, rng: Optional[random.Random] = None) -> int:
        return self.field.random_elem(rng)


class BN254Backend:
    name = "bn254"
    field: PrimeField = FR

    def __init__(self):
        self._g1_base = _c.g1_scalar_mul(_c.G1_GEN, params.ENCRYPT_G1_SCALE)
        self._g2_base = _c.g2_scalar_mul(_c.G2_GEN, params.ENCRYPT_G2_SCALE)

    def encrypt_g1(self, x: int):
        return _c.g1_scalar_mul(self._g1_base, x)

    def encrypt_g2(self, x: int):
        return _c.g2_scalar_mul(self._g2_base, x)

    def exp_g1(self, scalar: int, g1):
        return _c.g1_scalar_mul(g1, scalar)

    def exp_g2(self, scalar: int, g2):
        return _c.g2_scalar_mul(g2, scalar)

    def g1_zero(self):
        return _c.G1_INF

    def g2_zero(self):
        return _c.G2_INF

    def g1_add(self, a, b):
        return _c.g1_add(a, b)

    def g1_sub(self, a, b):
        return _c.g1_add(a, _c.g1_neg(b))

    def g2_add(self, a, b):
        return _c.g2_add(a, b)

    def pairing(self, g1, g2):
        return _c.pairing(g1, g2)

    def gt_add(self, a, b):
        return _c.fq12_mul(a, b)

    def gt_eq(self, a, b) -> bool:
        return a == b

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1 via the native library (single shared
        final exponentiation); python fallback when it cannot be built."""
        from ..curve import native

        return native.pairing_check(pairs)

    def random_g1(self, rng: Optional[random.Random] = None):
        return self.encrypt_g1(self.field.random_elem(rng))

    def random_g2(self, rng: Optional[random.Random] = None):
        return self.encrypt_g2(self.field.random_elem(rng))
