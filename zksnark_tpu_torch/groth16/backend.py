"""The BN254 pairing backend of the Groth16 protocol (host tier).

The port's own copy of `BN254Backend` from `zksnark_tpu/groth16/
backend.py`: encrypt_g1(x) = (69*G1)*x and encrypt_g2(x) = (96*G2)*x,
GT elements are Fq12 values and GT "addition" is Fq12 multiplication.
"""

from __future__ import annotations

from ..curve import bn254 as _c
from ..field import params
from ..field.host import FR, PrimeField


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
