"""Word8/Word64 wire bundles and Keccak permutation constants.

The port's own copy of `zksnark_tpu/builder/words.py`: little-endian
bit-vector bundles of wire ids.  A Word8 is a list of 8 wire ids (index 0 =
least-significant bit); a Word64 is a list of 8 Word8s (index 0 = least
significant byte).  Rotations are pure wire permutations: no constraints.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

Word8 = List[int]   # 8 wire ids, LSB first
Word64 = List[Word8]  # 8 bytes, least-significant byte first


def word8(wires: Iterable[int]) -> Word8:
    w = list(wires)
    if len(w) != 8:
        raise ValueError(
            "to_word8: Word8 must be constructed from exactly 8 wires")
    return w


def word64(wires: Iterable[int]) -> Word64:
    w = list(wires)
    if len(w) != 64:
        raise ValueError(
            "to_word64: Word64 must be constructed from exactly 64 wires")
    return [w[i * 8:(i + 1) * 8] for i in range(8)]


def iter_word64_bits(wrd: Word64) -> Iterator[int]:
    for byte in wrd:
        yield from byte


def flatten_word8(words: Iterable[Word8]) -> List[int]:
    """Concatenate the bit wires of a stream of Word8s."""
    out: List[int] = []
    for w in words:
        out.extend(w)
    return out


def flatten_word64(words: Iterable[Word64]) -> List[int]:
    out: List[int] = []
    for w in words:
        out.extend(iter_word64_bits(w))
    return out


def rotate_word64_left(wrd: Word64, by: int) -> Word64:
    """Bit at position i moves to position (i + by) % 64."""
    bits = list(iter_word64_bits(wrd))
    by %= 64
    rotated = bits[-by:] + bits[:-by] if by else bits
    return word64(rotated)


def rotate_word64_right(wrd: Word64, by: int) -> Word64:
    """Bit at position i moves to position (i - by) % 64."""
    bits = list(iter_word64_bits(wrd))
    by %= 64
    rotated = bits[by:] + bits[:by] if by else bits
    return word64(rotated)


# Keccak-f[1600] round constants / rotation offsets / pi lane order
# (the standard Keccak constants)
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808a,
    0x8000000080008000, 0x000000000000808b, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008a,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000a,
    0x000000008000808b, 0x800000000000008b, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800a, 0x800000008000000a, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

RHO = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43,
       62, 18, 39, 61, 20, 44]

PI = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2,
      20, 14, 22, 9, 6, 1]
