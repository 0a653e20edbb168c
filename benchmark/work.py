"""What a prove's device work needs, counted from its inputs alone, the
same whatever implements it: the least time of the five MSMs and of the
quotient, against the peaks of `peaks.py`.

Least time = max(bytes / HBM bandwidth, 32-bit multiply-adds / INT32
rate), each input read once and each output written once.

MSM: the cheapest known bucket method.  A scalar s >= 2^127 is split by
the curve's endomorphism (GLV, on G1 and G2 alike) into two halves of 127
bits; a smaller scalar is taken whole.  At window width c each half takes
ceil(127 / c) windows, and each non-zero c-bit digit is one bucket add:
the digits of the scalars as they are for s < 2^127 (so a 0/1 witness
costs one add a one), and (1 - 2^-c) a window for each half of a larger
scalar (the share of non-zero digits of a uniform half).  Each window in
use then costs 2^c adds to reduce its 2^(c-1) signed-digit buckets, and
joining W windows costs (W - 1) (c doublings + 1 add).  Adds are affine
with a shared inversion (5 products and a square: 6 Fq products in G1,
17 in G2 at 3 per Fq2 product and 2 per square); a doubling is dbl-2009-l
(7 in G1, 16 in G2).  c is the width that minimises the count.  Bytes:
each point set read once (64 B an affine G1 point, 128 B a G2 point),
each scalar once (32 B).  The coefficients of u, v and h are counted as
full-width scalars (`full`), the witness's as they are.

Quotient: 7 size-n transforms (3 inverse, 3 coset forward, 1 coset
inverse), n/2 log2 n butterflies each at one product, and one product per
non-zero of the constraint system; bytes: each non-zero once (a 4-byte
wire index and a 32-byte value), the witness once, and the three
coefficient vectors u, v, h written once.
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np

from . import peaks

HALF_BITS = 127
ADD = {"g1": 6, "g2": 17}
DOUBLE = {"g1": 7, "g2": 16}
POINT_BYTES = {"g1": 64, "g2": 128}
SCALAR_BYTES = 32
WIDTHS = range(1, 25)


class Work(NamedTuple):
    products: float      # 256-bit Montgomery products
    bytes: float

    @property
    def least_s(self) -> float:
        return max(self.bytes / peaks.HBM_BYTES_PER_S,
                   self.products * peaks.MULADDS_PER_MONT_MUL
                   / peaks.INT32_MULADD_PER_S)

    @property
    def bound(self) -> str:
        ops = (self.products * peaks.MULADDS_PER_MONT_MUL
               / peaks.INT32_MULADD_PER_S)
        return "ops" if ops >= self.bytes / peaks.HBM_BYTES_PER_S else "bytes"


def _classes(limbs: np.ndarray):
    """(count of scalars >= 2^127, (lo, hi) uint64 words of the non-zero
    scalars below 2^127) of (N, 8) little-endian 32-bit limbs."""
    w = limbs.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    big = (w[:, 4:] != 0).any(axis=1) | ((w[:, 3] >> np.uint64(31)) != 0)
    lo = w[:, 0] | (w[:, 1] << np.uint64(32))
    hi = w[:, 2] | (w[:, 3] << np.uint64(32))
    small = ~big & ((lo != 0) | (hi != 0))
    return int(big.sum()), lo[small], hi[small]


def _digit(lo, hi, off: int, c: int):
    mask = np.uint64((1 << c) - 1)
    if off + c <= 64:
        return (lo >> np.uint64(off)) & mask
    if off >= 64:
        return (hi >> np.uint64(off - 64)) & mask
    low = lo >> np.uint64(off)
    return (low | (hi << np.uint64(64 - off))) & mask


def scalar_limbs(values) -> np.ndarray:
    """(N, 8) little-endian 32-bit limbs of scalars in [0, 2^256)."""
    data = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(data, dtype="<u4").reshape(-1, 8)


def msm_products(group: str, limbs: Optional[np.ndarray] = None,
                 full: int = 0) -> Tuple[float, int]:
    """(Fq products, best window width) of one MSM over the scalars
    `limbs` and `full` more scalars >= 2^127 (a polynomial's coefficients,
    uniform in Fr: one below 2^127 has the chance 2^-127)."""
    if limbs is None:
        n_big, lo, hi = 0, np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    else:
        n_big, lo, hi = _classes(limbs)
    n_big += full
    best = None
    for c in WIDTHS:
        windows = -(-HALF_BITS // c)
        nonzero = [int(np.count_nonzero(_digit(lo, hi, j * c, c)))
                   for j in range(windows)]
        digits = sum(nonzero) + 2 * n_big * windows * (1 - 2.0 ** -c)
        used = windows if n_big else sum(1 for k in nonzero if k)
        cost = (digits + used * 2 ** c) * ADD[group]
        if used > 1:
            cost += (used - 1) * (c * DOUBLE[group] + ADD[group])
        if best is None or cost < best[0]:
            best = (cost, c)
    return best


def msm_work(jobs: Iterable[Tuple[str, Optional[np.ndarray], int]],
             point_sets: Iterable[Tuple[str, int]],
             scalars_read: int) -> Work:
    """The MSMs `jobs` ((group, (N, 8) scalar limbs or None, full-width
    scalars) each) over the point sets `point_sets` ((group, points)
    each, every set read once), with `scalars_read` distinct scalars
    read."""
    products = sum(msm_products(g, s, full)[0] for g, s, full in jobs)
    nbytes = (sum(POINT_BYTES[g] * k for g, k in point_sets)
              + SCALAR_BYTES * scalars_read)
    return Work(products, nbytes)


def quotient_work(n: int, nnz: int, num_wires: int) -> Work:
    butterflies = 7 * (n // 2) * int(math.log2(n))
    return Work(butterflies + nnz,
                nnz * (4 + SCALAR_BYTES) + SCALAR_BYTES * (num_wires + 3 * n))
