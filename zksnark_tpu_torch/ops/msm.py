"""Multi-scalar multiplication (Pippenger) and batched scalar multiplication.

Counterpart of `zksnark_tpu/ops/msm.py`, in the same formulation:

- c-bit windows; ONE batched sort orders every window's digit column
  (`torch.sort`, whose indices are the permutation);
- per window, bucket sums are read off a prefix scan of the sorted points,
  in chunks of 64 positions: one launch (`curve_kernels.bucket_scan`)
  scans every chunk of every window side by side (`madd` when the points
  are affine-or-infinity), reading the points through the permutation
  and writing each bucket's run-end prefix to its slot; the chunk carries
  and the tree sum are block scans (`curve_kernels.block_scan`), one
  launch a level, two levels each at 2^20 points;
- the weighted bucket reduction is Abel summation,
      sum_j j*B_j = 2^c * E_top - sum_j E_j,
  with E_j the prefix at the end of the last non-empty bucket <= j —
  emptiness is an explicit validity flag (not the infinity sentinel), so
  a bucket whose points cancel exactly still counts as present;
- the windows are then combined by Horner, MSB window first.

The JAX package maps the per-window procedure over windows with `vmap`;
here the window is a batch axis of every tensor.  The tail's adds read
their operands through index tensors (`curve_kernels.add_gather`, an
index < 0 standing for infinity), so no gathered or broadcast copy of a
point array is made: the bucket ends with their forward fill and the
block carries' fix-up are one launch each.  The Abel step (an add, the
doubling chain, the negation and an add) and the Horner tail are one
launch each (`curve_kernels.abel`, `curve_kernels.horner`).

The block scans associate the tail's adds otherwise than the JAX
package's chunked scans, so a window sum or an MSM is another Jacobian
representative of the JAX package's point: equal in affine form.

Fixed-base form (the prover's MSMs, whose points are fixed per CRS):
`window_table` precomputes 2^(c w) P for every window w, and
`msm_tables` runs an MSM as ONE window of 2^c buckets over those W N
rows, sum_i s_i P_i = sum_i sum_w d_{i,w} (2^(c w) P_i): the same bucket
scan work, one tail instead of W and no Horner.  The generic `msm`,
`msm_windowed` and the mesh path keep the windowed form.

Scalars are standard-form (N, 8) int32 limbs; points are `JPoint` batches.
"""

from __future__ import annotations

import math

import torch

from ..curve import jacobian as jac
from ..curve.jacobian import JPoint
from ..field import params
from . import curve_kernels as ck

L = params.NUM_LIMBS
_CHUNK = 64


def _cat(a: JPoint, b: JPoint, dim: int = 0) -> JPoint:
    return JPoint(*(torch.cat([u, v], dim) for u, v in zip(a, b)))


def _index(p: JPoint, idx) -> JPoint:
    return JPoint(p.x[idx], p.y[idx], p.z[idx])


def _batch_shape(ops, p: JPoint):
    return p.z.shape[:p.z.dim() - ops.elem_ndim]


def _positions(ops, pts: JPoint, n: int) -> torch.Tensor:
    """The flat row index of every point of the first n positions of
    `pts` along axis 0, int32, in the shape of those positions."""
    shape = (n,) + tuple(_batch_shape(ops, pts)[1:])
    return torch.arange(math.prod(shape), dtype=torch.int32,
                        device=pts.z.device).reshape(shape)


def _pad_to(ops, pts: JPoint, m: int) -> JPoint:
    n = pts.z.shape[0]
    if m == n:
        return pts
    rest = _batch_shape(ops, pts)[1:]
    return _cat(pts, jac.infinity(ops, (m - n,) + rest, pts.z.device))


def _block_shape(ops, pts: JPoint):
    n = pts.z.shape[0]
    return ck.block_scan_shape(n, math.prod(_batch_shape(ops, pts)[1:]))


def _prefix_scan(ops, pts: JPoint) -> JPoint:
    """Inclusive prefix scan over axis 0 (identity = infinity): one block
    scan, and where it leaves more than one block a column, the prefix
    scan of the block totals and one fix-up that adds each block's carry
    (~2N adds)."""
    n = pts.z.shape[0]
    if n <= 1:
        return pts
    threads, steps = _block_shape(ops, pts)
    totals, within = ck.block_scan(ops, pts, True, threads, steps)
    if totals.z.shape[0] == 1:
        return within
    carry = _prefix_scan(ops, totals)                        # (blocks, ...)
    # position i gets the inclusive carry of the block before its own
    # (row -r + col < 0, infinity, in block 0)
    i = _positions(ops, pts, n)
    r = i[0].numel()
    return ck.add_gather(ops, carry, (i // (threads * steps * r) - 1) * r
                         + i % r, within, i)


def tree_sum(ops, pts: JPoint) -> JPoint:
    """Total of a batch of points over axis 0: one block scan a level
    (work N)."""
    while pts.z.shape[0] > 1:
        pts, _ = ck.block_scan(ops, pts, False, *_block_shape(ops, pts))
    return _index(pts, 0)


def batch_scalar_mul(ops, pts: JPoint, scalar_limbs: torch.Tensor) -> JPoint:
    """[s_i] P_i for every i — MSB-first double-and-add over 256 bits.
    The small-N correctness oracle (`msm_naive`)."""
    words = scalar_limbs.to(torch.int64) & 0xFFFFFFFF
    acc = jac.infinity(ops, (pts.z.shape[0],), pts.z.device)
    for t in range(32 * L - 1, -1, -1):
        bit = ((words[:, t // 32] >> (t % 32)) & 1).bool()
        acc = jac.double(ops, acc)
        acc = jac.select(ops, bit, jac.add(ops, acc, pts), acc)
    return acc


def _digit_columns(scalar_limbs: torch.Tensor, c: int,
                   scalar_bits: int = 0) -> torch.Tensor:
    """(N, 8) u32-limb scalars -> (n_windows, N) int64 c-bit window
    columns, LSB window first (a window may straddle two limbs).

    scalar_bits > 0 bounds the scalars: only the ceil(min(scalar_bits,
    256) / c) low windows are built (a scalar at or above 2^scalar_bits
    loses its high windows)."""
    words = scalar_limbs.to(torch.int64) & 0xFFFFFFFF
    n_bits = min(scalar_bits, 32 * L) if scalar_bits > 0 else 32 * L
    n_win = -(-n_bits // c)
    mask = (1 << c) - 1
    cols = []
    for w in range(n_win):
        lo, sh = divmod(w * c, 32)
        d = words[:, lo] >> sh
        if sh + c > 32 and lo + 1 < L:
            d = d | (words[:, lo + 1] << (32 - sh))
        cols.append(d & mask)
    return torch.stack(cols)


def _pack(p: JPoint, lead) -> torch.Tensor:
    """[X | Y | Z] rows: one gather or scatter moves all three coords."""
    return torch.cat([a.reshape(lead + (-1,)) for a in p], dim=-1)


def _unpack(packed: torch.Tensor, elem) -> JPoint:
    w = packed.shape[-1] // 3
    lead = packed.shape[:-1]
    return JPoint(*(packed[..., k * w:(k + 1) * w].reshape(lead + elem)
                    for k in range(3)))


def _fill_indices(bucket_chunk: torch.Tensor, valid: torch.Tensor):
    """The operands of the bucket ends' forward fill, as `add_gather`
    indices laid out (num_buckets, W): E_j of window w, the prefix at the
    end of the last NON-EMPTY bucket l <= j (an int running max over the
    explicit validity flag, not the infinity sentinel), is carry row
    (chunk of l) * W + w plus ends_w row w * num_buckets + l; both -1
    (infinity) before the window's first bucket."""
    W, nb = valid.shape
    dev = valid.device
    src = torch.where(valid, torch.arange(nb, dtype=torch.int32,
                                          device=dev), -1)
    last = torch.cummax(src, dim=1).values                    # (W, nb)
    live = last >= 0
    w = torch.arange(W, dtype=torch.int32, device=dev).unsqueeze(1)
    chunk = torch.gather(bucket_chunk, 1, last.clamp(min=0).long())
    pi = torch.where(live, chunk.to(torch.int32) * W + w, -1)
    qi = torch.where(live, w * nb + last, -1)
    return pi.t(), qi.t()


def _bucket_windows_sorted(ops, pts: JPoint, order: torch.Tensor,
                           d_sorted: torch.Tensor, num_buckets: int,
                           affine: bool) -> JPoint:
    """sum_i digit_i * P_i for every window at once, given the per-window
    sort permutation `order` and sorted digits `d_sorted` (both (W, N)).
    Returns the (W,) window sums."""
    # one launch: each (window, chunk of cdim sorted positions) lane scans
    # its points and leaves the within-chunk prefix at every run end in
    # its bucket's slot (ends_w), with the chunk index and a validity
    # flag; empty buckets keep (infinity, chunk 0), and carry[0] is
    # infinity
    cdim = min(_CHUNK, order.shape[1])
    return _bucket_tail(ops, *ck.bucket_scan(
        ops, pts, order, d_sorted, num_buckets, cdim, affine), num_buckets)


def _bucket_tail(ops, ends_w: JPoint, bucket_chunk: torch.Tensor,
                 valid: torch.Tensor, totals: JPoint,
                 num_buckets: int) -> JPoint:
    """The (W,) Abel sums sum_j j*B_j of W windows from their bucket scan
    (`curve_kernels.bucket_scan`'s slots, chunk indices, validity flags
    and (B, W) chunk totals)."""
    b, W = totals.z.shape[:2]
    dev = totals.z.device

    # exclusive chunk carries (~2B general adds)
    shifted = _cat(jac.infinity(ops, (1, W), dev),
                   _index(totals, slice(0, b - 1)))
    carry = _prefix_scan(ops, shifted)                        # (B, W)

    # forward-filled bucket ends E_j, (num_buckets, W): one gather-add
    pi, qi = _fill_indices(bucket_chunk, valid)
    filled = ck.add_gather(ops, carry, pi, ends_w, qi)

    # Abel: sum_j j*B_j = num_buckets * E_top - sum_j E_j.  E_top is the
    # window's point total: last chunk carry + last chunk total.
    rhs = tree_sum(ops, filled)
    return ck.abel(ops, _index(carry, b - 1), _index(totals, b - 1), rhs,
                   num_buckets.bit_length() - 1)


def window_sums(ops, pts: JPoint, scalar_limbs: torch.Tensor,
                window_bits: int, affine: bool = False,
                scalar_bits: int = 0) -> JPoint:
    """The (W,) window sums of Pippenger over exactly these N points, LSB
    window first: what the Horner tail combines.  W = ceil(256 / c), or
    ceil(scalar_bits / c) under a bound (`_digit_columns`)."""
    digit_cols = _digit_columns(scalar_limbs, window_bits,
                                scalar_bits)                 # (W, N)
    d_sorted, order = torch.sort(digit_cols, dim=1)
    return _bucket_windows_sorted(
        ops, pts, order, d_sorted, 1 << window_bits, affine)


def msm_windowed(ops, pts: JPoint, scalar_limbs: torch.Tensor,
                 window_bits: int, affine: bool = False,
                 scalar_bits: int = 0) -> JPoint:
    """Pippenger over exactly these N points (no padding)."""
    # Horner across windows, MSB window first: acc = 2^c * acc + W_w
    return ck.horner(ops, window_sums(ops, pts, scalar_limbs, window_bits,
                                      affine, scalar_bits), window_bits)


def msm_windowed_batch(ops, jobs, window_bits: int,
                       affine: bool = False) -> list:
    """`msm_windowed` of each (points, scalars) job, the jobs' Horner
    tails side by side in one `horner` call (the window sums of each job
    are computed one job at a time).  The JAX package's
    `_msm_windowed_many` computes the same results."""
    sums = [window_sums(ops, p, s, window_bits, affine) for p, s in jobs]
    out = ck.horner(ops, JPoint(*(torch.stack(c, dim=1)
                                  for c in zip(*sums))), window_bits)
    return [_index(out, i) for i in range(len(jobs))]


def table_windows(window_bits: int) -> int:
    """W = ceil(256 / c): the blocks of a window table, the windows of a
    full-width scalar."""
    return -(-32 * L // window_bits)


def window_table(ops, pts: JPoint, window_bits: int) -> JPoint:
    """The fixed-base window table of affine-or-infinity points P of batch
    shape (..., N): batch shape (..., W, N), block w = 2^(c w) P for
    w < W = `table_windows(c)`, every row affine-or-infinity.  Block
    w + 1 is block w after c doublings (one `double_n` launch a block for
    every set of the leading axes); then one `batch_normalize` a set over
    its W - 1 new blocks (one host inverse a set).  Block 0 is P."""
    e = ops.elem_ndim
    k = pts.z.dim() - e - 1                   # leading axes
    W = table_windows(window_bits)
    table = JPoint(*(a.new_empty(a.shape[:k] + (W,) + a.shape[k:])
                     for a in pts))
    block = pts
    for w in range(W):
        if w:
            block = ck.double_n(ops, block, window_bits)
        for t, a in zip(table, block):
            t.select(k, w).copy_(a)
    if W > 1:
        sets = JPoint(*(t.reshape((-1, W) + t.shape[k + 1:])
                        for t in table))
        for s in range(sets.z.shape[0]):
            new = JPoint(*(a[s, 1:] for a in sets))
            for a, b in zip(new, jac.batch_normalize(ops, new)):
                a.copy_(b)
    return table


def msm_tables(ops, groups, window_bits: int) -> list:
    """Fixed-base MSMs over window tables (`window_table`).  With
    d_{i,w} the c-bit digits of s_i,
        sum_i s_i P_i = sum_i sum_w d_{i,w} (2^(c w) P_i),
    one window of 2^c buckets over the W N rows of P's table, its digit
    column laid out w-major as the table's rows: one sort, one bucket
    scan over W N rows, one tail (the chunk carries, the bucket ends'
    fill and tree sum over 2^c ends, one Abel step) and no Horner.

    groups: (table, [scalars, ...]) pairs: a table of W N rows in W
    blocks (batch axes flattened) and (N, 8) standard-form scalars, every
    table of one number of rows.  A group's MSMs are the windows of one
    sort and one bucket scan; every MSM's tail runs in one pass, the MSMs
    side by side as its windows.  Returns the MSMs' results, group by
    group, each group's in its scalars' order."""
    nb = 1 << window_bits
    rows = groups[0][0].z.shape[0]
    scans = []
    for table, scalars in groups:
        cols = torch.stack([_digit_columns(s, window_bits).reshape(-1)
                            for s in scalars])                # (J, W N)
        if not cols.shape[1] == table.z.shape[0] == rows:
            raise ValueError(f"msm_tables: {cols.shape[1]} digits a scalar "
                             f"set for a table of {table.z.shape[0]} rows, "
                             f"every table {rows} rows")
        d_sorted, order = torch.sort(cols, dim=1)
        scans.append(ck.bucket_scan(ops, table, order, d_sorted, nb,
                                    min(_CHUNK, rows), True))
    ends_w, bucket_chunk, valid, totals = scans[0]
    if len(scans) > 1:
        ends_w, totals = (JPoint(*(torch.cat(c, dim) for c in zip(
            *(s[i] for s in scans)))) for i, dim in ((0, 0), (3, 1)))
        bucket_chunk, valid = (torch.cat([s[i] for s in scans])
                               for i in (1, 2))
    out = _bucket_tail(ops, ends_w, bucket_chunk, valid, totals, nb)
    return [_index(out, j) for j in range(out.z.shape[0])]


def pick_window_bits(n: int) -> int:
    """c ~ log2(N) - 2, clamped to [4, 16]: per-window point work (~2N adds
    regardless of c) against bucket work (~3 * 2^c adds)."""
    return max(4, min(16, n.bit_length() - 3))


@torch.inference_mode()
def msm(ops, pts: JPoint, scalar_limbs: torch.Tensor,
        window_bits: int = 0, affine: bool = False,
        scalar_bits: int = 0) -> JPoint:
    """Pippenger MSM: the single point sum_i s_i * P_i.

    pts: JPoint batch of N points; scalar_limbs: (N, 8) standard form.
    N is padded to the next power of two (>= 64) with infinity / zero
    terms, as in the JAX package.  affine=True asserts every Z is 0 or
    one (the batch_normalize invariant) and runs the bucket scans on the
    mixed-add kernel.

    scalar_bits > 0 is a bound the caller guarantees: every scalar is
    < 2^scalar_bits.  Only the windows below it are built, scanned and
    folded (the bucket scan and Horner run with W = ceil(scalar_bits /
    c)); a scalar above the bound loses its high windows and the result
    is WRONG, as in the JAX package.  Leave 0 for general scalars."""
    n = pts.z.shape[0]
    m = max(64, 1 << (n - 1).bit_length())
    if m != n:
        pts = _pad_to(ops, pts, m)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (m - n, L))])
    if window_bits == 0:
        window_bits = pick_window_bits(m)
    return msm_windowed(ops, pts, scalar_limbs, window_bits, affine,
                        scalar_bits)


@torch.inference_mode()
def msm_naive(ops, pts: JPoint, scalar_limbs: torch.Tensor) -> JPoint:
    """Reference MSM: batched scalar-mul then tree reduction."""
    return tree_sum(ops, batch_scalar_mul(ops, pts, scalar_limbs))
