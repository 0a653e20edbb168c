"""Work-efficient prefix scans and segmented sums over field-element arrays.

Counterpart of `zksnark_tpu/ops/scans.py`.  Setup needs "accumulate value
v into wire i" over every sparse constraint entry — a scatter-add in Fr,
which has no hardware reduction.  Entries are sorted by key, the values
prefix-scanned (field addition is associative), and each segment's sum
read off the run-boundary prefixes:

    seg[s] = E_end[s] - E_end[prev present segment]

The scan lays values out as (chunks, 64) and walks the 64 positions with
all chunks side by side (~2N field adds).
"""

from __future__ import annotations

import torch

from ..field import params
from ..field.limb import MontCtx, add as l_add, sub as l_sub

L = params.NUM_LIMBS
_CHUNK = 64


def _hs_scan(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """Small-size inclusive Hillis-Steele scan over axis 0 (identity 0)."""
    size = x.shape[0]
    if size <= 1:
        return x
    for i in range((size - 1).bit_length()):
        shift = 1 << i
        partner = torch.cat([torch.zeros_like(x[:shift]), x[:-shift]])
        x = l_add(ctx, partner, x)
    return x


def field_prefix_scan(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums (mod p) of a (n, 8) limb array."""
    n = x.shape[0]
    if n <= 2 * _CHUNK:
        return _hs_scan(ctx, x)
    b = -(-n // _CHUNK)
    if b * _CHUNK != n:
        x = torch.cat([x, torch.zeros((b * _CHUNK - n, L), dtype=x.dtype,
                                      device=x.device)])
    grid = x.reshape(b, _CHUNK, L).transpose(0, 1)        # (c, B, L)
    within = torch.empty((_CHUNK, b, L), dtype=x.dtype, device=x.device)
    acc = torch.zeros((b, L), dtype=x.dtype, device=x.device)
    for j in range(_CHUNK):
        acc = l_add(ctx, acc, grid[j])
        within[j] = acc
    shifted = torch.cat([torch.zeros_like(acc[:1]), acc[:-1]])
    carry = field_prefix_scan(ctx, shifted)
    full = l_add(ctx, carry.unsqueeze(0), within)          # (c, B, L)
    return full.transpose(0, 1).reshape(b * _CHUNK, L)[:n]


def field_segment_sums(ctx: MontCtx, keys: torch.Tensor, vals: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum of vals grouped by key: (E,) int keys + (E, 8) values ->
    (num_segments, 8) per-segment field sums.  Keys need not be sorted;
    empty segments sum to zero."""
    k_sorted, order = torch.sort(keys.to(torch.int64))
    prefix = field_prefix_scan(ctx, vals[order])

    nxt = torch.cat([k_sorted[1:], k_sorted.new_full((1,), num_segments)])
    run_end = k_sorted != nxt
    drop = k_sorted.new_full((), num_segments)
    # scatter into num_segments + 1 rows; the last row takes the non-ends
    rows = torch.zeros((num_segments + 1, L), dtype=vals.dtype,
                       device=vals.device)
    ends = rows.index_copy(0, torch.where(run_end, k_sorted, drop), prefix)
    # the run-end prefix of segment s is also "everything before" the NEXT
    # present segment: scatter it there and subtract
    prevs = rows.index_copy(0, torch.where(run_end, nxt, drop), prefix)
    return l_sub(ctx, ends[:num_segments], prevs[:num_segments])
