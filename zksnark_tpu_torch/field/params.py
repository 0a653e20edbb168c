"""BN254 (alt_bn128) parameter constants, and the port's limb layout.

Curve: y^2 = x^3 + 3 over Fq, r = #E(Fq) prime, with the standard BN
parametrization  q = 36u^4 + 36u^3 + 24u^2 + 6u + 1,
               r = 36u^4 + 36u^3 + 18u^2 + 6u + 1,  u = 4965661367192848881.

The curve constants are the same numbers as `zksnark_tpu.field.params`;
the limb layout is the port's own: a field element is 8 little-endian
u32 limbs (held as the bit patterns of int32 tensor lanes) of its
canonical Montgomery residue.  The Montgomery radix R = 2^256 is the same
in both packages, so a residue is the same 256-bit number in both.
"""

# BN parameter
BN_U = 4965661367192848881
# Optimal-ate Miller loop count
BN_SIX_U_PLUS_2 = 6 * BN_U + 2

# Base field modulus (Fq)
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus (Fr) — the circuit/witness field
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

assert Q == 36 * BN_U**4 + 36 * BN_U**3 + 24 * BN_U**2 + 6 * BN_U + 1
assert R == 36 * BN_U**4 + 36 * BN_U**3 + 18 * BN_U**2 + 6 * BN_U + 1

# Fr multiplicative-group structure: r - 1 = 2^TWO_ADICITY * FR_ODD_ORDER
FR_TWO_ADICITY = 28
FR_ODD_ORDER = (R - 1) >> FR_TWO_ADICITY
assert FR_ODD_ORDER % 2 == 1 and (FR_ODD_ORDER << FR_TWO_ADICITY) == R - 1
# Smallest multiplicative generator of Fr*
FR_GENERATOR = 5
# Canonical 2^28-th root of unity used by every radix-2 NTT domain.
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_ODD_ORDER, R)

# G1 generator (the curve's canonical affine generator)
G1_GEN = (1, 2)

# CRS elements are encrypted against *scaled* generators:
# encrypt_g1(x) = (69 * G1) * x and encrypt_g2(x) = (96 * G2) * x.
ENCRYPT_G1_SCALE = 69
ENCRYPT_G2_SCALE = 96

# Fq2 = Fq[u] / (u^2 + 1); elements a + b*u written (a, b).
# G2: y^2 = x^3 + b/xi on the sextic twist, xi = 9 + u.
XI = (9, 1)

# G2 generator (standard alt_bn128 / EIP-197 generator)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# ---------------------------------------------------------------------------
# Limb layout: 8 little-endian u32 limbs per field element
# ---------------------------------------------------------------------------
LIMB_BITS = 32
NUM_LIMBS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_R = 1 << (LIMB_BITS * NUM_LIMBS)  # 2^256

# The JAX package's layout of the same residues: 32 little-endian 8-bit
# digits in float32 lanes (`zksnark_tpu.field.limb`).
JAX_DIGIT_BITS = 8
JAX_NUM_DIGITS = 32


def mont_constants(p: int):
    """(R mod p, R^2 mod p, -p^-1 mod 2^32) for modulus p < 2^256.  The
    last is the word constant of the u32 CIOS reduction."""
    r_mod = MONT_R % p
    r2_mod = (MONT_R * MONT_R) % p
    n0inv = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    return r_mod, r2_mod, n0inv


def to_limbs(x: int, n: int = NUM_LIMBS):
    """Little-endian u32 limb decomposition of a non-negative int."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def from_limbs(limbs) -> int:
    acc = 0
    for i, l in enumerate(limbs):
        acc |= (int(l) & LIMB_MASK) << (LIMB_BITS * i)
    return acc
