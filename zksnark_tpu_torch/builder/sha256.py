"""SHA256Compress and a Merkle authentication path in R1CS, built as
libsnark builds them (`sha256_compression_function_gadget`,
`merkle_tree_check_read_gadget` with `sha256_two_to_one_hash_gadget`).

Bits travel as lists of wires.  A *stream* (a digest, a block) is
MSB-first by byte, as the bytes are written; a *word* is 32 wires, least
significant bit first, so bit i weighs 2^i in a packing.

Per compression (26,968 constraints; libsnark's gadget makes ~27,904):

- message schedule: the 16 block words packed (one packing constraint
  each); each of the 48 more words as sigma1 + W[j-7] + sigma0 + W[j-16]
  by `lastbits_add` (34 bits), then packed.  sigma0 / sigma1 are
  three-way XORs, two of the builder's xor gates (a - b)^2 a bit, one
  where the shift leaves a zero, and a packing.
- 64 rounds: Sigma0, Sigma1 (three-way XORs and a packing each), Ch (one
  constraint a bit: e (f - g) = ch - g), Maj (a private bit check and one
  constraint with an empty C a bit: (x + y + z - 2 m)(1 - x - y - z +
  2 m) = 0), d and h packed, new a and new e by `lastbits_add` (35 bits).
- the output: each final word packed and added to its state word (33
  bits).

`merkle_path` climbs a path of these compressions from the standard IV
(Zcash Sprout's MerkleCRH: SHA256Compress(left || right)), with a digest
selector by the position bit at each level.
"""

from __future__ import annotations

from typing import List, Sequence

from .circuit import Circuit, UNITY_WIRE

IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

Word = List[int]


def stream_words(bits: Sequence[int]) -> List[Word]:
    """A stream of 32 k bits -> k words, LSB first."""
    return [list(reversed(bits[32 * k:32 * k + 32]))
            for k in range(len(bits) // 32)]


def words_stream(words: Sequence[Word]) -> List[int]:
    return [b for w in words for b in reversed(w)]


def bytes_stream(data: bytes) -> List[int]:
    """The bits of `data`, MSB first by byte (the values of a stream)."""
    return [(byte >> (7 - i)) & 1 for byte in data for i in range(8)]


def const_stream(c: Circuit, words: Sequence[int]) -> List[int]:
    """32-bit constants as a stream of the zero and unity wires."""
    return words_stream([[c.const_wire((x >> i) & 1) for i in range(32)]
                         for x in words])


def _xor3(c: Circuit, x: int, y: int, z) -> int:
    t = c.new_xor(x, y)
    return t if z is None else c.new_xor(t, z)


def big_sigma(c: Circuit, x: Word, r1: int, r2: int, r3: int) -> int:
    """Packed rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3)."""
    return c.pack([_xor3(c, x[(i + r1) % 32], x[(i + r2) % 32],
                         x[(i + r3) % 32]) for i in range(32)])


def small_sigma(c: Circuit, x: Word, r1: int, r2: int, shift: int) -> int:
    """Packed rotr(x, r1) ^ rotr(x, r2) ^ (x >> shift)."""
    return c.pack([_xor3(c, x[(i + r1) % 32], x[(i + r2) % 32],
                         x[i + shift] if i + shift < 32 else None)
                   for i in range(32)])


def choice(c: Circuit, e: Word, f: Word, g: Word) -> int:
    """Packed Ch(e, f, g): a hint bit ch and e (f - g) = ch - g a bit."""
    bits = []
    for ei, fi, gi in zip(e, f, g):
        r = c.new_hint(lambda a, b, d: b if a else d, [ei, fi, gi])
        c.new_constraint([(1, ei)], [(1, fi), (-1, gi)], [(1, r), (-1, gi)])
        bits.append(r)
    return c.pack(bits)


def majority(c: Circuit, x: Word, y: Word, z: Word) -> int:
    """Packed Maj(x, y, z): a checked hint bit m and (x + y + z - 2 m)
    (1 - x - y - z + 2 m) = 0 a bit."""
    bits = []
    for xi, yi, zi in zip(x, y, z):
        r = c.new_hint(lambda a, b, d: int(a + b + d >= 2), [xi, yi, zi])
        c.enforce_bit(r)
        s = [(1, xi), (1, yi), (1, zi), (-2, r)]
        c.new_constraint(s, [(1, UNITY_WIRE)] + [(-w, v) for w, v in s])
        bits.append(r)
    return c.pack(bits)


def sha256_compress(c: Circuit, state_bits: Sequence[int],
                    block_bits: Sequence[int]) -> List[int]:
    """SHA-256's compression function of a 256-bit state and a 512-bit
    block (streams of wires), no padding; returns the output stream."""
    state = stream_words(state_bits)
    w = stream_words(block_bits)
    wp = [c.pack(x) for x in w]
    for j in range(16, 64):
        s0 = small_sigma(c, w[j - 15], 7, 18, 3)
        s1 = small_sigma(c, w[j - 2], 17, 19, 10)
        bits = c.lastbits_add([(1, s1), (1, wp[j - 7]), (1, s0),
                               (1, wp[j - 16])], 0, 32, 2)
        w.append(bits)
        wp.append(c.pack(bits))

    a, b, cc, d, e, f, g, h = state
    packed_d, packed_h = [], []
    for i in range(64):
        s0 = big_sigma(c, a, 2, 13, 22)
        s1 = big_sigma(c, e, 6, 11, 25)
        ch = choice(c, e, f, g)
        mj = majority(c, a, b, cc)
        pd, ph = c.pack(d), c.pack(h)
        packed_d.append(pd)
        packed_h.append(ph)
        new_a = c.lastbits_add([(1, ph), (1, s1), (1, ch), (1, wp[i]),
                                (1, s0), (1, mj)], K[i], 32, 3)
        new_e = c.lastbits_add([(1, pd), (1, ph), (1, s1), (1, ch),
                                (1, wp[i])], K[i], 32, 3)
        h, g, f, e, d, cc, b, a = g, f, e, new_e, cc, b, a, new_a

    # the state's packed words: d of rounds 3 .. 0, h of rounds 3 .. 0
    init = [packed_d[3 - k] for k in range(4)] + [packed_h[3 - k]
                                                  for k in range(4)]
    out = []
    for k, final in enumerate((a, b, cc, d, e, f, g, h)):
        pf = c.pack(final)
        out.append(c.lastbits_add([(1, init[k]), (1, pf)], 0, 32, 1))
    return words_stream(out)


def merkle_path(c: Circuit, leaf_bits: Sequence[int],
                position_bits: Sequence[int],
                sibling_bits: Sequence[Sequence[int]]) -> List[int]:
    """The root of a Merkle authentication path (libsnark's
    `merkle_tree_check_read_gadget`): the leaf's 256 bits checked, then
    at each level i, from the leaf up, the position bit checked, the
    left and right digests as hints from it, the current digest and the
    sibling's bits (sibling_bits[i], values only), their 512 bits
    checked, the digest selector pos (right - left) = cur - left a bit,
    and cur = SHA256Compress(IV, left || right).  Returns the root's
    stream."""
    iv = const_stream(c, IV)
    for bit in leaf_bits:
        c.enforce_bit(bit)
    cur = list(leaf_bits)
    for pos, sib in zip(position_bits, sibling_bits):
        c.enforce_bit(pos)
        left = [c.new_hint(lambda p, x, s: s if p else x, [pos, x, s])
                for x, s in zip(cur, sib)]
        right = [c.new_hint(lambda p, x, s: x if p else s, [pos, x, s])
                 for x, s in zip(cur, sib)]
        for bit in left + right:
            c.enforce_bit(bit)
        for x, lb, rb in zip(cur, left, right):
            c.new_constraint([(1, pos)], [(1, rb), (-1, lb)],
                             [(1, x), (-1, lb)])
        cur = sha256_compress(c, iv, left + right)
    return cur
