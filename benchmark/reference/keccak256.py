"""The in-circuit Keccak-256 of a private preimage, as a list of gates.

A frozen copy of the circuit the system under test builds (its builder's
`Circuit.keccak256` over `preimage_bytes` private bytes, then one bit
checker per preimage bit): the same gates in the same order, since gate g
sits at the domain point omega^g.  Each gate multiplies two linear
combinations of wires:

    xor(a, b):  (a - b) * (a - b)       not(a): 1 * (1 - a)
    and(a, b):  a * b                   bit(a): a * (a - 1)

The public wires are the unity wire, the digest's 256 bits and the 8 *
preimage_bytes bit checkers (which are 0).  The digest that the circuit's
evaluation gives is held against `keccak.keccak256` of the preimage: a
reference circuit that disagrees with the plain hash fails its own check.
"""

from __future__ import annotations

from typing import List

from . import keccak
from .groth16 import R, Lagrange, Sums

ZERO, UNITY = 0, 1
XOR, NOT, AND, BIT = range(4)
RATE = 136


def _terms(kind: int, a: int, b: int):
    """(left, right) lists of (coefficient, wire) of one gate."""
    if kind == XOR:
        t = [(1, a), (-1, b)]
        return t, t
    if kind == NOT:
        return [(1, UNITY)], [(1, UNITY), (-1, a)]
    if kind == AND:
        return [(1, a)], [(1, b)]
    return [(1, a)], [(1, a), (-1, UNITY)]


class _Builder:
    def __init__(self):
        self.next_wire = 2
        self.kind: List[int] = []
        self.a: List[int] = []
        self.b: List[int] = []
        self.out: List[int] = []

    def wire(self) -> int:
        self.next_wire += 1
        return self.next_wire - 1

    def gate(self, kind: int, a: int, b: int = ZERO) -> int:
        o = self.wire()
        self.kind.append(kind)
        self.a.append(a)
        self.b.append(b)
        self.out.append(o)
        return o

    def xor(self, x: List[int], y: List[int]) -> List[int]:
        return [self.gate(XOR, u, v) for u, v in zip(x, y)]

    def keccak_f(self, a: List[List[int]]) -> List[List[int]]:
        """keccak-f[1600] on 25 lanes of 64 bit wires (bit i of lane x +
        5 y at a[x + 5 y][i])."""
        for rc in keccak.RC:
            c = [const_lane(0) for _ in range(5)]
            for x in range(5):
                for y in range(5):
                    c[x] = self.xor(c[x], a[x + 5 * y])
            for x in range(5):
                for y in range(5):
                    i = x + 5 * y
                    a[i] = self.xor(self.xor(a[i], c[(x + 4) % 5]),
                                    rotl(c[(x + 1) % 5], 1))
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(
                        a[x + 5 * y], keccak.ROT[x][y])
            a = b
            for y in range(5):
                row = [a[x + 5 * y] for x in range(5)]
                for x in range(5):
                    nots = [self.gate(NOT, w) for w in row[(x + 1) % 5]]
                    ands = [self.gate(AND, u, v)
                            for u, v in zip(nots, row[(x + 2) % 5])]
                    a[x + 5 * y] = self.xor(row[x], ands)
            a[0] = self.xor(a[0], const_lane(rc))
        return a

    def xor_byte(self, state, pos: int, byte: List[int]) -> None:
        lane, sub = divmod(pos, 8)
        bits = state[lane]
        bits[8 * sub:8 * sub + 8] = self.xor(bits[8 * sub:8 * sub + 8], byte)

    def keccak256(self, data: List[List[int]]) -> List[int]:
        """Digest bits (32 bytes, little-endian bits) of the byte wires."""
        state = [const_lane(0) for _ in range(25)]
        offset = 0
        while len(data) >= RATE - offset:
            take = RATE - offset
            for i, byte in enumerate(data[:take]):
                self.xor_byte(state, offset + i, byte)
            state = self.keccak_f(state)
            data, offset = data[take:], 0
        for i, byte in enumerate(data):
            self.xor_byte(state, offset + i, byte)
        offset += len(data)
        self.xor_byte(state, offset, const_byte(0x01))
        self.xor_byte(state, RATE - 1, const_byte(0x80))
        state = self.keccak_f(state)
        return [w for lane in state[:4] for w in lane]


def const_lane(value: int) -> List[int]:
    return [UNITY if (value >> i) & 1 else ZERO for i in range(64)]


def const_byte(value: int) -> List[int]:
    return [UNITY if (value >> i) & 1 else ZERO for i in range(8)]


def rotl(lane: List[int], n: int) -> List[int]:
    return [lane[(i - n) % 64] for i in range(64)]


def bits_of(data: bytes) -> List[int]:
    return [(byte >> i) & 1 for byte in data for i in range(8)]


class Gates:
    """A built list of gates with its input and verify (public) wires:
    its evaluation on input bits and its sums at x."""

    def __init__(self, bld: _Builder, inputs: List[int], verify: List[int]):
        self.b, self.inputs, self.verify = bld, inputs, verify
        self.n_gates = len(bld.kind)
        self.public = len(verify)
        self.public_wires = {UNITY, *verify}
        # gates with a public term or a public output, for the _pub sums
        self.pub_gates = []
        self.nnz = 0
        for g, (k, a, b, o) in enumerate(zip(bld.kind, bld.a, bld.b,
                                             bld.out)):
            left, right = _terms(k, a, b)
            self.nnz += len(left) + len(right) + 1
            if o in self.public_wires or any(
                    w in self.public_wires for _, w in left + right):
                self.pub_gates.append((g, left, right, o))
        used = {ZERO, UNITY, *bld.out, *bld.a,
                *[b for k, b in zip(bld.kind, bld.b) if k in (XOR, AND)]}
        self.num_wires = len(used)

    def evaluate(self, bits: List[int]) -> List[int]:
        """Every wire's value (0 or 1), in gate order."""
        bld = self.b
        val = [0] * bld.next_wire
        val[UNITY] = 1
        for w, bit in zip(self.inputs, bits):
            val[w] = bit
        for k, a, b, o in zip(bld.kind, bld.a, bld.b, bld.out):
            if k == XOR:
                val[o] = val[a] ^ val[b]
            elif k == NOT:
                val[o] = 1 - val[a]
            elif k == AND:
                val[o] = val[a] & val[b]
            else:
                val[o] = val[a] * (val[a] - 1)
        return val

    def sums(self, bits: List[int], want: List[int], lag: Lagrange):
        """(Sums, the number of the reference's own checks that fail: a
        gate whose product is not its output, a verify wire whose value
        is not `want`'s)."""
        bld = self.b
        val = self.evaluate(bits)
        left, right, out = [], [], []
        for k, a, b, o in zip(bld.kind, bld.a, bld.b, bld.out):
            if k == XOR:
                d = val[a] - val[b]
                left.append(d)
                right.append(d)
            elif k == NOT:
                left.append(1)
                right.append(1 - val[a])
            elif k == AND:
                left.append(val[a])
                right.append(val[b])
            else:
                left.append(val[a])
                right.append(val[a] - 1)
            out.append(val[o])
        errors = sum(1 for lv, rv, ov in zip(left, right, out)
                     if (lv * rv - ov) % R)
        errors += sum(1 for w, bit in zip(self.verify, want) if val[w] != bit)
        pub = [0, 0, 0]
        pw = self.public_wires
        for g, lt, rt, o in self.pub_gates:
            lg = lag.at(g)
            pub[0] += lg * sum(c * val[w] for c, w in lt if w in pw)
            pub[1] += lg * sum(c * val[w] for c, w in rt if w in pw)
            if o in pw:
                pub[2] += lg * val[o]
        return Sums(lag.dot(left), lag.dot(right), lag.dot(out),
                    pub[0] % R, pub[1] % R, pub[2] % R), errors


class Reference(Gates):
    def __init__(self, cfg: dict):
        self.n_bytes = int(cfg["preimage_bytes"])
        bld = _Builder()
        inputs = [[bld.wire() for _ in range(8)] for _ in range(self.n_bytes)]
        digest = bld.keccak256(inputs)
        flat = [w for byte in inputs for w in byte]
        checkers = [bld.gate(BIT, w) for w in flat]
        super().__init__(bld, flat, digest + checkers)

    def sums(self, preimage: bytes, lag: Lagrange):
        """The preimage's sums; its verify wires are held against the
        plain hash's bits and zero checkers."""
        want = bits_of(keccak.keccak256(bytes(preimage))) + [0] * len(
            self.inputs)
        return super().sums(bits_of(preimage), want, lag)
