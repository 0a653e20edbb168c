"""Zcash Sprout's note-commitment path: a Merkle authentication path of
SHA256Compress (MerkleCRH^Sprout(left, right) = SHA256Compress(left ||
right), MerkleDepth^Sprout = 29), as a list of R1CS gates.

A frozen copy of the circuit the system under test builds (its builder's
`sha256.merkle_path` as libsnark's gadgets make it; its gates in the same
order, since gate g sits at the domain point omega^g).  Each gate is
(sum A) * (sum B) = (sum C) over wires; a linear combination names each
wire once (terms merged in order of first appearance, zero terms
dropped), but the xor gate (a - b)^2, whose two terms are kept as they
are.  Wires that the gates' values set by hand (a packing, the bits of a
sum, Ch, Maj, the left and right digests) are evaluated here from their
own definitions.

Gates, in order: a bit check of each of the leaf's 256 bits; for each of
`depth` levels from the leaf up, the position bit's check, the left
digest's and the right digest's 256 bit checks, 256 selector gates
pos (right - left) = cur - left, and SHA256Compress(IV, left || right)
(26,968 gates); then the root's bits multipacked into two public wires
(253 + 3 bits, bit j of the root's stream weighing 2^j).

The public wires are the unity wire and the two packed root elements.
The root that the gates' evaluation gives is held against a plain
SHA256Compress chain (`merkle_root`), itself held against `hashlib`'s
SHA-256 in the tests: a reference circuit that disagrees fails its own
check.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

from .groth16 import R, Lagrange, Sums

ZERO, UNITY = 0, 1
PACK_BITS = 253

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
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# plain SHA256Compress and the path's root
# ---------------------------------------------------------------------------

def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_compress(state: Sequence[int], block: bytes) -> List[int]:
    """SHA-256's compression function: eight 32-bit words and a 64-byte
    block -> eight words (FIPS 180-4, section 6.2.2, one block)."""
    w = [int.from_bytes(block[4 * i:4 * i + 4], "big") for i in range(16)]
    for j in range(16, 64):
        s0 = _rotr(w[j - 15], 7) ^ _rotr(w[j - 15], 18) ^ (w[j - 15] >> 3)
        s1 = _rotr(w[j - 2], 17) ^ _rotr(w[j - 2], 19) ^ (w[j - 2] >> 10)
        w.append((w[j - 16] + s0 + w[j - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for j in range(64):
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + ((e & f) ^ (~e & g)) + K[j] + w[j]) & M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (
            t1 + t2) & M32
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def merkle_crh(left: bytes, right: bytes) -> bytes:
    """MerkleCRH^Sprout: SHA256Compress of the 64-byte block left || right
    from the standard IV, no padding."""
    return b"".join(x.to_bytes(4, "big")
                    for x in sha256_compress(IV, left + right))


def merkle_root(leaf: bytes, position: int,
                siblings: Sequence[bytes]) -> bytes:
    """The root over `leaf` at `position` (bit i: the node at level i is
    a right child) with its siblings from the leaf up."""
    cur = leaf
    for i, sib in enumerate(siblings):
        cur = (merkle_crh(sib, cur) if (position >> i) & 1
               else merkle_crh(cur, sib))
    return cur


def stream_of(data: bytes) -> List[int]:
    """The bits of `data`, MSB first by byte."""
    return [(byte >> (7 - i)) & 1 for byte in data for i in range(8)]


def packed_root(root: bytes) -> List[int]:
    """The two public elements: the root's stream bits 0 .. 252 and 253 ..
    255, bit j of a chunk weighing 2^j."""
    bits = stream_of(root)
    return [sum(b << j for j, b in enumerate(bits[i:i + PACK_BITS]))
            for i in range(0, len(bits), PACK_BITS)]


# ---------------------------------------------------------------------------
# the gates of one level
# ---------------------------------------------------------------------------

# value kinds of the wires a level sets (op codes)
XOR, PACK, SPLIT, CH, MAJ, LEFT, RIGHT = range(7)

Lc = Tuple[Tuple[int, int], ...]


def _lc(terms) -> Lc:
    acc: dict = {}
    for c, w in terms:
        acc[w] = (acc.get(w, 0) + c) % R
    return tuple((c, w) for w, c in acc.items() if c)


class _Level:
    """One level's gates over local wires: 0 zero, 1 unity, 2 .. 257 the
    current digest's stream, 258 the position bit, 259 .. 514 the
    sibling's stream (values only), then the level's own wires.  `ops`
    sets the level's wires in order, `gates` is its gate list."""

    CUR, POS, SIB = 2, 258, 259

    def __init__(self):
        self.next = 515
        self.ops: list = []
        self.gates: List[Tuple[Lc, Lc, Lc]] = []
        cur = list(range(self.CUR, self.CUR + 256))
        sib = list(range(self.SIB, self.SIB + 256))
        pos = self.POS
        self.check(pos)
        left = [self.op(LEFT, pos, x, s) for x, s in zip(cur, sib)]
        right = [self.op(RIGHT, pos, x, s) for x, s in zip(cur, sib)]
        for b in left + right:
            self.check(b)
        for x, lb, rb in zip(cur, left, right):
            self.gate([(1, pos)], [(1, rb), (-1, lb)], [(1, x), (-1, lb)])
        iv = [b for x in IV for b in
              [UNITY if (x >> (31 - i)) & 1 else ZERO for i in range(32)]]
        self.out = self.compress(iv, left + right)

    # -- wires and gates -------------------------------------------------
    def op(self, kind: int, *args) -> int:
        w = self.next
        self.next += 1
        self.ops.append((kind, w, args))
        return w

    def gate(self, a, b, c=()) -> None:
        self.gates.append((_lc(a), _lc(b), _lc(c)))

    def check(self, w: int) -> None:
        self.gate([(1, w)], [(1, w), (-1, UNITY)])

    def xor(self, a: int, b: int) -> int:
        o = self.op(XOR, a, b)
        t = ((1, a), (R - 1, b))
        self.gates.append((t, t, ((1, o),)))
        return o

    def pack(self, bits: List[int]) -> int:
        p = self.op(PACK, tuple(bits))
        self.gate([(1, UNITY)], [(1 << i, b) for i, b in enumerate(bits)],
                  [(1, p)])
        return p

    def add(self, words: List[int], const: int, total: int) -> List[int]:
        """The bits of sum(words) + const (`total` of them), one packing
        gate and a check a bit; the low 32."""
        first = self.next
        self.next += total
        self.ops.append((SPLIT, first, (tuple(words), const, total)))
        bits = list(range(first, first + total))
        self.gate([(1, UNITY)], [(1 << i, b) for i, b in enumerate(bits)],
                  [(1, w) for w in words] + [(const, UNITY)])
        for b in bits:
            self.check(b)
        return bits[:32]

    # -- SHA256Compress ----------------------------------------------------
    def sigma(self, x, r1, r2, r3=None, shift=None) -> int:
        bits = []
        for i in range(32):
            t = self.xor(x[(i + r1) % 32], x[(i + r2) % 32])
            if r3 is not None:
                t = self.xor(t, x[(i + r3) % 32])
            elif i + shift < 32:
                t = self.xor(t, x[i + shift])
            bits.append(t)
        return self.pack(bits)

    def choice(self, e, f, g) -> int:
        bits = []
        for ei, fi, gi in zip(e, f, g):
            r = self.op(CH, ei, fi, gi)
            self.gate([(1, ei)], [(1, fi), (-1, gi)], [(1, r), (-1, gi)])
            bits.append(r)
        return self.pack(bits)

    def majority(self, x, y, z) -> int:
        bits = []
        for xi, yi, zi in zip(x, y, z):
            r = self.op(MAJ, xi, yi, zi)
            self.check(r)
            s = [(1, xi), (1, yi), (1, zi), (-2, r)]
            self.gate(s, [(1, UNITY)] + [(-c, w) for c, w in s])
            bits.append(r)
        return self.pack(bits)

    def compress(self, state_bits: List[int], block_bits: List[int]):
        def words(bits):
            return [list(reversed(bits[32 * k:32 * k + 32]))
                    for k in range(len(bits) // 32)]

        state, w = words(state_bits), words(block_bits)
        wp = [self.pack(x) for x in w]
        for j in range(16, 64):
            s0 = self.sigma(w[j - 15], 7, 18, shift=3)
            s1 = self.sigma(w[j - 2], 17, 19, shift=10)
            bits = self.add([s1, wp[j - 7], s0, wp[j - 16]], 0, 34)
            w.append(bits)
            wp.append(self.pack(bits))
        a, b, c, d, e, f, g, h = state
        pds, phs = [], []
        for i in range(64):
            s0 = self.sigma(a, 2, 13, 22)
            s1 = self.sigma(e, 6, 11, 25)
            ch = self.choice(e, f, g)
            mj = self.majority(a, b, c)
            pd, ph = self.pack(d), self.pack(h)
            pds.append(pd)
            phs.append(ph)
            na = self.add([ph, s1, ch, wp[i], s0, mj], K[i], 35)
            ne = self.add([pd, ph, s1, ch, wp[i]], K[i], 35)
            h, g, f, e, d, c, b, a = g, f, e, ne, c, b, a, na
        init = [pds[3 - k] for k in range(4)] + [phs[3 - k] for k in range(4)]
        out = [self.add([init[k], self.pack(fin)], 0, 33)
               for k, fin in enumerate((a, b, c, d, e, f, g, h))]
        return [bit for word in out for bit in reversed(word)]

    # -- evaluation ----------------------------------------------------------
    def run(self, cur: List[int], pos: int, sib: List[int]) -> list:
        """Every local wire's value for the current digest's bits, the
        position bit and the sibling's bits."""
        val = [0] * self.next
        val[UNITY] = 1
        val[self.CUR:self.CUR + 256] = cur
        val[self.POS] = pos
        val[self.SIB:self.SIB + 256] = sib
        for kind, o, args in self.ops:
            if kind == XOR:
                val[o] = (val[args[0]] - val[args[1]]) ** 2 % R
            elif kind == PACK:
                val[o] = sum(val[b] << i for i, b in enumerate(args[0]))
            elif kind == SPLIT:
                words, const, total = args
                s = sum(val[w] for w in words) + const
                val[o:o + total] = [(s >> i) & 1 for i in range(total)]
            elif kind == CH:
                e, f, g = (val[x] for x in args)
                val[o] = f if e else g
            elif kind == MAJ:
                val[o] = int(sum(val[x] for x in args) >= 2)
            else:
                p, x, s = (val[y] for y in args)
                val[o] = (s if p else x) if kind == LEFT else (x if p else s)
        return val


# ---------------------------------------------------------------------------
# the whole path
# ---------------------------------------------------------------------------

def _dot(lc: Lc, val) -> int:
    return sum(c * val[w] for c, w in lc)


def _widths(gates) -> List[Counter]:
    return [Counter(len(g[i]) for g in gates) for i in range(3)]


class Reference:
    """The path's gates and, per statement, their sums at x."""

    def __init__(self, cfg: dict):
        self.depth = int(cfg["depth"])
        self.level = lv = _Level()
        per = len(lv.gates)
        self.n_gates = 256 + self.depth * per + 2
        self.public = 2
        # widths: u, v, w histograms of the gates' term counts; the leaf's
        # checks have 1, 2, 0 terms, the multipack's 1, 253 or 3, 1
        level_widths = _widths(lv.gates)
        self.widths = []
        for i in range(3):
            hist = Counter()
            for k, cnt in level_widths[i].items():
                hist[k] += cnt * self.depth
            hist[(1, 2, 0)[i]] += 256
            hist[(1, 253, 1)[i]] += 1
            hist[(1, 3, 1)[i]] += 1
            self.widths.append(hist)
        self.nnz = sum(k * cnt for hist in self.widths
                       for k, cnt in hist.items())
        used = set()
        for g in lv.gates:
            for lc in g:
                used.update(w for _, w in lc)
        own = used - set(range(lv.CUR, lv.CUR + 256)) - {ZERO, UNITY}
        zero = ZERO in used
        # unity, zero, the leaf's bits, each level's own wires, the two
        # public elements
        self.num_wires = 1 + zero + 256 + self.depth * len(own) + 2
        # the unity wire's coefficient in each level gate's A, B, C
        self.unity = [[sum(c for c, w in lc if w == UNITY) % R
                       for lc in g] for g in lv.gates]

    def sums(self, statement, lag: Lagrange):
        """(Sums, the number of the reference's own checks that fail: a
        gate whose product is not its output, a root or public element
        unlike the plain chain's)."""
        leaf, position, siblings = statement
        lv, e = self.level, lag.e
        acc = [0, 0, 0]
        pub = [0, 0, 0]
        errors = 0
        # the leaf's bit checks: b * (b - 1) = 0
        cur = stream_of(leaf)
        for g, b in enumerate(cur):
            acc[0] += e[g] * b
            acc[1] += e[g] * (b - 1)
            pub[1] -= e[g]
            errors += (b * (b - 1)) % R != 0
        off = 256
        for i, sib in enumerate(siblings):
            val = lv.run(cur, (position >> i) & 1, stream_of(sib))
            for j, (a, b, c) in enumerate(lv.gates):
                av, bv, cv = _dot(a, val), _dot(b, val), _dot(c, val)
                eg = e[off + j]
                acc[0] += eg * av
                acc[1] += eg * bv
                acc[2] += eg * cv
                errors += (av * bv - cv) % R != 0
                ua, ub, uc = self.unity[j]
                if ua or ub or uc:
                    pub[0] += eg * ua
                    pub[1] += eg * ub
                    pub[2] += eg * uc
            cur = [val[w] for w in lv.out]
            off += len(lv.gates)
        want = merkle_root(leaf, position, siblings)
        errors += cur != stream_of(want)
        # the multipack: 1 * (sum 2^j bit_j) = p, p the public element
        for k, p in enumerate(packed_root(want)):
            chunk = cur[PACK_BITS * k:PACK_BITS * (k + 1)]
            got = sum(b << j for j, b in enumerate(chunk))
            errors += got != p
            acc[0] += e[off + k]
            acc[1] += e[off + k] * got
            acc[2] += e[off + k] * p
            pub[0] += e[off + k]
            pub[2] += e[off + k] * p
        s = lag.scale
        return Sums(*(s * (x % R) % R for x in acc + pub)), errors
