"""Multi-scalar multiplication (Pippenger) and batched scalar multiplication.

Counterpart of `zksnark_tpu/ops/msm.py`, in the same formulation:

- c-bit windows; ONE batched sort orders every window's digit column
  (`torch.sort`, whose indices are the permutation);
- per window, bucket sums are read off a prefix scan of the sorted points,
  in chunks of 64 positions: one launch (`curve_kernels.bucket_scan`)
  scans every chunk of every window side by side (`madd` when the points
  are affine-or-infinity), reading the points through the permutation
  and writing each bucket's run-end prefix to its slot; the chunk carries
  and the tree sum are add scans, one launch each
  (`curve_kernels.add_scan`);
- the weighted bucket reduction is Abel summation,
      sum_j j*B_j = 2^c * E_top - sum_j E_j,
  with E_j the prefix at the end of the last non-empty bucket <= j —
  emptiness is an explicit validity flag (not the infinity sentinel), so
  a bucket whose points cancel exactly still counts as present;
- the windows are then combined by Horner, MSB window first.

The JAX package maps the per-window procedure over windows with `vmap`;
here the window is a batch axis of every tensor.  The Abel doubling chain
and the Horner tail are one launch each (`curve_kernels.double_n`,
`curve_kernels.horner`).

Scalars are standard-form (N, 8) int32 limbs; points are `JPoint` batches.
"""

from __future__ import annotations

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


def _hs_scan(ops, pts: JPoint) -> JPoint:
    """Inclusive Hillis-Steele prefix scan along axis 0 (identity =
    infinity); only for small sizes."""
    size = pts.z.shape[0]
    if size <= 1:
        return pts
    rest = _batch_shape(ops, pts)[1:]
    for i in range((size - 1).bit_length()):
        shift = 1 << i
        inf = jac.infinity(ops, (min(shift, size),) + rest, pts.z.device)
        partner = _cat(inf, _index(pts, slice(0, size - shift)))
        pts = jac.add(ops, partner, pts)
    return pts


def _pad_to(ops, pts: JPoint, m: int) -> JPoint:
    n = pts.z.shape[0]
    if m == n:
        return pts
    rest = _batch_shape(ops, pts)[1:]
    return _cat(pts, jac.infinity(ops, (m - n,) + rest, pts.z.device))


def _scan_chunks(ops, pts: JPoint, c: int, collect: bool):
    """Lay axis 0 out as (B, c) in place and scan the c sequential
    positions with all B chunks (and any further batch axes) side by side,
    in one add-scan launch.  Returns (totals (B, ...), within (B, c, ...)
    or None)."""
    n = pts.z.shape[0]
    b = -(-n // c)
    pts = _pad_to(ops, pts, b * c)
    grid = JPoint(*(a.reshape((b, c) + a.shape[1:]) for a in pts))
    return ck.add_scan(ops, grid, collect)


def _prefix_scan(ops, pts: JPoint) -> JPoint:
    """Work-efficient inclusive prefix scan over axis 0 (~2N adds)."""
    n = pts.z.shape[0]
    if n <= 2 * _CHUNK:
        return _hs_scan(ops, pts)
    totals, within = _scan_chunks(ops, pts, _CHUNK, collect=True)
    b = totals.z.shape[0]
    rest = _batch_shape(ops, totals)[1:]
    shifted = _cat(jac.infinity(ops, (1,) + rest, pts.z.device),
                   _index(totals, slice(0, b - 1)))
    carry = _prefix_scan(ops, shifted)                         # (B, ...)
    full = jac.add(ops, JPoint(*(a.unsqueeze(1) for a in carry)), within)
    full = JPoint(*(a.reshape((b * _CHUNK,) + a.shape[2:]) for a in full))
    return _index(full, slice(0, n))


def tree_sum(ops, pts: JPoint) -> JPoint:
    """Total of a batch of points over axis 0: repeated chunked scan-sums
    (work N, one add-scan launch per level)."""
    while pts.z.shape[0] > 1:
        c = min(_CHUNK, pts.z.shape[0])
        pts, _ = _scan_chunks(ops, pts, c, collect=False)
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


def _digit_columns(scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """(N, 8) u32-limb scalars -> (n_windows, N) int64 c-bit window
    columns, LSB window first (a window may straddle two limbs)."""
    words = scalar_limbs.to(torch.int64) & 0xFFFFFFFF
    n_win = -(-32 * L // c)
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


def _bucket_windows_sorted(ops, pts: JPoint, order: torch.Tensor,
                           d_sorted: torch.Tensor, num_buckets: int,
                           affine: bool) -> JPoint:
    """sum_i digit_i * P_i for every window at once, given the per-window
    sort permutation `order` and sorted digits `d_sorted` (both (W, N)).
    Returns the (W,) window sums."""
    W, n = order.shape
    dev = pts.z.device
    elem = pts.x.shape[1:]
    cdim = min(_CHUNK, n)
    b = -(-n // cdim)

    # one launch: each (window, chunk of cdim sorted positions) lane scans
    # its points and leaves the within-chunk prefix at every run end in
    # its bucket's slot (ends_w), with the chunk index and a validity
    # flag; empty buckets keep (infinity, chunk 0), and carry[0] is
    # infinity
    ends_w, bucket_chunk, valid, totals = ck.bucket_scan(
        ops, pts, order, d_sorted, num_buckets, cdim, affine)

    # exclusive chunk carries (~2B general adds)
    shifted = _cat(jac.infinity(ops, (1, W), dev),
                   _index(totals, slice(0, b - 1)))
    carry = _prefix_scan(ops, shifted)                        # (B, W)
    carry_rows = _pack(carry, (b * W,))
    ends_c = _unpack(carry_rows[bucket_chunk * W + torch.arange(
        W, device=dev).unsqueeze(1)], elem)
    ends = jac.add(ops, ends_c, ends_w)                       # (W, nb)

    # forward-fill E_j = prefix at the end of the last NON-EMPTY bucket
    # <= j, from an explicit validity flag and an int running max
    src = torch.where(valid, torch.arange(num_buckets, device=dev),
                      torch.full((), -1, device=dev, dtype=torch.int64))
    last_valid = torch.cummax(src, dim=1).values
    filled = _unpack(torch.gather(
        _pack(ends, (W, num_buckets)), 1,
        last_valid.clamp(min=0).unsqueeze(-1).expand(
            -1, -1, 3 * ends.x[0, 0].numel())), elem)
    filled = jac.select(ops, last_valid < 0,
                        jac.infinity(ops, (W, num_buckets), dev), filled)

    # Abel: sum_j j*B_j = num_buckets * E_top - sum_j E_j.  E_top is the
    # window's point total: last chunk carry + last chunk total.
    e_top = jac.add(ops, _index(carry, b - 1), _index(totals, b - 1))
    lhs = ck.double_n(ops, e_top, num_buckets.bit_length() - 1)
    rhs = tree_sum(ops, JPoint(*(a.transpose(0, 1) for a in filled)))
    return jac.add(ops, lhs, jac.neg(ops, rhs))


def window_sums(ops, pts: JPoint, scalar_limbs: torch.Tensor,
                window_bits: int, affine: bool = False) -> JPoint:
    """The (W,) window sums of Pippenger over exactly these N points, LSB
    window first: what the Horner tail combines."""
    digit_cols = _digit_columns(scalar_limbs, window_bits)   # (W, N)
    d_sorted, order = torch.sort(digit_cols, dim=1)
    return _bucket_windows_sorted(
        ops, pts, order, d_sorted, 1 << window_bits, affine)


def msm_windowed(ops, pts: JPoint, scalar_limbs: torch.Tensor,
                 window_bits: int, affine: bool = False) -> JPoint:
    """Pippenger over exactly these N points (no padding)."""
    # Horner across windows, MSB window first: acc = 2^c * acc + W_w
    return ck.horner(ops, window_sums(ops, pts, scalar_limbs, window_bits,
                                      affine), window_bits)


def msm_windowed_batch(ops, jobs, window_bits: int,
                       affine: bool = False) -> list:
    """`msm_windowed` of each (points, scalars) job, the jobs' Horner
    tails side by side in one `horner` call (the window sums of each job
    are computed one job at a time)."""
    sums = [window_sums(ops, p, s, window_bits, affine) for p, s in jobs]
    out = ck.horner(ops, JPoint(*(torch.stack(c, dim=1)
                                  for c in zip(*sums))), window_bits)
    return [_index(out, i) for i in range(len(jobs))]


def pick_window_bits(n: int) -> int:
    """c ~ log2(N) - 2, clamped to [4, 16]: per-window point work (~2N adds
    regardless of c) against bucket work (~3 * 2^c adds)."""
    return max(4, min(16, n.bit_length() - 3))


@torch.inference_mode()
def msm(ops, pts: JPoint, scalar_limbs: torch.Tensor,
        window_bits: int = 0, affine: bool = False) -> JPoint:
    """Pippenger MSM: the single point sum_i s_i * P_i.

    pts: JPoint batch of N points; scalar_limbs: (N, 8) standard form.
    N is padded to the next power of two (>= 64) with infinity / zero
    terms, as in the JAX package.  affine=True asserts every Z is 0 or
    one (the batch_normalize invariant) and runs the bucket scans on the
    mixed-add kernel."""
    n = pts.z.shape[0]
    m = max(64, 1 << (n - 1).bit_length())
    if m != n:
        pts = _pad_to(ops, pts, m)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (m - n, L))])
    if window_bits == 0:
        window_bits = pick_window_bits(m)
    return msm_windowed(ops, pts, scalar_limbs, window_bits, affine)


@torch.inference_mode()
def msm_naive(ops, pts: JPoint, scalar_limbs: torch.Tensor) -> JPoint:
    """Reference MSM: batched scalar-mul then tree reduction."""
    return tree_sum(ops, batch_scalar_mul(ops, pts, scalar_limbs))
