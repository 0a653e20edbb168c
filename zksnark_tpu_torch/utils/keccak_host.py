"""Host Keccak-256 (original 0x01 padding, Ethereum flavor).

The port's own copy of `zksnark_tpu/utils/keccak_host.py`: the oracle for
the in-circuit Keccak gadget and the digest a proof's public input
carries.  Plain-int keccak-f[1600] from the Keccak specification.
"""

from __future__ import annotations

from typing import List, Sequence

from ..builder.words import PI, RC, RHO

_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f1600(state: List[int]) -> List[int]:
    """One permutation over 25 64-bit lanes (in-place style, returns state)."""
    a = list(state)
    for rnd in range(24):
        # Theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[5 * y + x] ^= d[x]
        # Rho and pi
        last = a[1]
        for x in range(24):
            tmp = a[PI[x]]
            a[PI[x]] = _rotl(last, RHO[x])
            last = tmp
        # Chi
        for y in range(5):
            row = [a[5 * y + x] for x in range(5)]
            for x in range(5):
                a[5 * y + x] = row[x] ^ ((~row[(x + 1) % 5]) & _MASK64
                                         & row[(x + 2) % 5])
        # Iota
        a[0] ^= RC[rnd]
    return a


def keccak256(data: Sequence[int]) -> bytes:
    """Keccak-256 of a byte sequence (delim 0x01, rate 136)."""
    rate = 136
    state = [0] * 25

    def xorin(offset: int, chunk: Sequence[int]) -> None:
        for i, byte in enumerate(chunk):
            pos = offset + i
            state[pos // 8] ^= (byte & 0xFF) << (8 * (pos % 8))

    data = list(data)
    offset = 0
    while len(data) >= rate - offset:
        take = rate - offset
        xorin(offset, data[:take])
        state[:] = keccak_f1600(state)
        data = data[take:]
        offset = 0
    xorin(offset, data)
    offset += len(data)

    state[offset // 8] ^= 0x01 << (8 * (offset % 8))
    state[(rate - 1) // 8] ^= 0x80 << (8 * ((rate - 1) % 8))
    state[:] = keccak_f1600(state)

    out = bytearray()
    for lane in state[:4]:
        out.extend(lane.to_bytes(8, "little"))
    return bytes(out)
