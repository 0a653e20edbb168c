"""Keccak-256 as Ethereum uses it (pad 0x01 ... 0x80, rate 136 bytes), in
plain Python, written from the Keccak reference: the round constants come
from its LFSR and the rotation offsets from its (x, y) walk, so no table is
shared with the circuit under test.
"""

from __future__ import annotations

MASK = (1 << 64) - 1


def _round_constants():
    out, state = [], 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if state & 1:
                rc |= 1 << ((1 << j) - 1)
            state <<= 1
            if state & 0x100:
                state ^= 0x171          # x^8 + x^6 + x^5 + x^4 + 1
        out.append(rc)
    return out


def _rotations():
    r = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        r[x][y] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


RC = _round_constants()
ROT = _rotations()


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & MASK if n else v


def keccak_f(a):
    """Keccak-f[1600] on 25 lanes, lane (x, y) at index x + 5 y."""
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136
    msg = bytearray(data)
    msg.append(0x01)
    msg.extend(b"\x00" * (-len(msg) % rate))
    msg[-1] |= 0x80
    a = [0] * 25
    for off in range(0, len(msg), rate):
        block = msg[off:off + rate]
        for i in range(rate // 8):
            a[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        a = keccak_f(a)
    return b"".join(v.to_bytes(8, "little") for v in a)[:32]
