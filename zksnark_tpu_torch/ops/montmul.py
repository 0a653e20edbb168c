"""K1: batched Montgomery multiplication — the CUDA kernel
(`csrc/montmul.cu`), its plain PyTorch version, and the launch counts;
`mont_mul_add`, two Fr products with broadcast operands and their sum
in one launch; `wide_rows`, the segmented sums of Montgomery products
over a constraint matrix's wide rows (CSR) in one launch.

Counterpart of `zksnark_tpu/ops/montmul.py` (`mont_mul_pallas`,
`mont_mul_auto`, `from_mont_auto`).  `mont_mul` broadcasts its operands,
flattens them to (N, 8) and launches one thread per product on a CUDA
tensor; on a CPU tensor it runs the plain version (`field.limb.mont_mul`).
`mont_sqr`, `mont_pow_fixed` and `mont_inv` are the ladders of
`field.limb` on top of it: on a CUDA tensor each step is one launch
(`mont_inv`: 254 squarings and 127 products over Fr, 110 over Fq).

`mont_scan` and `normalize` are `batch_normalize`'s products
(`csrc/mont_scan.cu`): the inclusive prefix products along axis 1 of a
(B, c) grid of Fq or Fq2 elements, one launch for the grid (a block of
threads per row) where the JAX package's `_prefix_prod`
(`zksnark_tpu/curve/jacobian.py:203`) runs one launch per step; and the
pass that turns the prefix and suffix products into affine points, one
launch where its `_bn_apply` (:296) runs six products.
"""

from __future__ import annotations

import torch

from .. import _build
from ..field import limb
from ..field.limb import FR_CTX, MontCtx
from ..utils import profiling

L = limb.L

# launches of the kernels, by field (`profiling.launch_counts()`)
LAUNCHES = profiling.launch_counter(__name__, (
    "montmul_fr", "montmul_fq", "montmul_add_fr", "mont_scan_fq", "mont_scan_fq2", "normalize_fq", "normalize_fq2",
    "wide_rows_fr"))


def kernel_name(ctx: MontCtx) -> str:
    return "montmul_fr" if ctx.p == FR_CTX.p else "montmul_fq"


def mont_mul_plain(ctx: MontCtx, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    return limb.mont_mul(ctx, a, b)


def _flat(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != limb.DT or t.shape[-1] != L:
        raise ValueError(f"montmul kernel needs (..., {L}) int32 limbs, "
                         f"got {tuple(t.shape)} {t.dtype}")
    t = t.reshape(-1, L).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def mont_mul_cuda(ctx: MontCtx, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    fa, fb = _flat(a), _flat(b)
    out = torch.empty_like(fa)
    n = fa.shape[0]
    if n:
        code = _build.lib("montmul.cu").zk_montmul(
            fa.data_ptr(), fb.data_ptr(), out.data_ptr(), n,
            0 if ctx.p == FR_CTX.p else 1,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(code, "montmul")
        LAUNCHES[kernel_name(ctx)] += 1
    return out.reshape(shape)


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p, broadcasting; the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if a.device.type == "cuda":
        return mont_mul_cuda(ctx, a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    raise ValueError(f"mont_mul: unsupported device {a.device}")


def mont_mul_add_plain(a: torch.Tensor, b: torch.Tensor,
                       xy: torch.Tensor) -> torch.Tensor:
    return limb.add(FR_CTX, mont_mul_plain(FR_CTX, a, xy[0:1]),
                    mont_mul_plain(FR_CTX, b, xy[1:2]))


def mont_mul_add(a: torch.Tensor, b: torch.Tensor,
                 xy: torch.Tensor) -> torch.Tensor:
    """(a * xy[0] + b * xy[1]) * R^-1 mod r over Fr, for (N, 8) a and b
    and a (2, 8) xy: one launch of `zk_montmul_add` on CUDA tensors, the
    plain version (two products and `field.limb.add`) on CPU tensors."""
    if a.shape != b.shape or a.dim() != 2 or xy.shape != (2, L):
        raise ValueError(f"mont_mul_add: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, xy {tuple(xy.shape)}")
    if a.device.type == "cpu":
        return mont_mul_add_plain(a, b, xy)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul_add: unsupported device {a.device}")
    fa, fb, fxy = _flat(a), _flat(b), _flat(xy)
    out = torch.empty_like(fa)
    if out.shape[0]:
        code = _build.lib("montmul.cu").zk_montmul_add(
            fa.data_ptr(), fb.data_ptr(), fxy.data_ptr(), out.data_ptr(),
            out.shape[0], torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(code, "montmul_add")
        LAUNCHES["montmul_add_fr"] += 1
    return out


def wide_rows_plain(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                    ptr: torch.Tensor, rows: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """The plain version: every term's product, then a segmented field
    sum a row (`ops.scans.field_segment_sums`), copied into out's rows."""
    from . import scans

    n_rows = rows.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(n_rows, device=rows.device), ptr[1:] - ptr[:-1])
    prods = mont_mul_plain(FR_CTX, val, w[idx.to(torch.int64)])
    sums = scans.field_segment_sums(FR_CTX, seg, prods, n_rows)
    return out.index_copy_(0, rows, sums)


def wide_rows(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              ptr: torch.Tensor, rows: torch.Tensor, out: torch.Tensor,
              group: int = 32) -> torch.Tensor:
    """The wide rows of a matrix in CSR, over Fr in Montgomery form:
    out[rows[r]] = sum over j in [ptr[r], ptr[r + 1]) of val[j] *
    w[idx[j]] * R^-1, written into `out` (an (n, 8) tensor) and returned.
    idx int32, ptr and rows int64, `group` lanes to a row (a power of two
    up to 32).  One launch of `zk_wide_rows` on CUDA tensors; the plain
    version on CPU tensors."""
    if (idx.dtype != torch.int32 or ptr.dtype != torch.int64
            or rows.dtype != torch.int64 or val.shape != idx.shape + (L,)
            or ptr.shape != (rows.shape[0] + 1,) or out.dim() != 2):
        raise ValueError(
            f"wide_rows: idx {tuple(idx.shape)} {idx.dtype}, val "
            f"{tuple(val.shape)}, ptr {tuple(ptr.shape)} {ptr.dtype}, rows "
            f"{tuple(rows.shape)} {rows.dtype}, out {tuple(out.shape)}")
    if out.device.type == "cpu":
        return wide_rows_plain(w, idx, val, ptr, rows, out)
    if out.device.type != "cuda":
        raise ValueError(f"wide_rows: unsupported device {out.device}")
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("wide_rows: out must be contiguous and aligned")
    fw, fval = _flat(w), _flat(val)
    idx, ptr, rows = idx.contiguous(), ptr.contiguous(), rows.contiguous()
    if rows.shape[0]:
        code = _build.lib("montmul.cu").zk_wide_rows(
            fw.data_ptr(), idx.data_ptr(), fval.data_ptr(), ptr.data_ptr(),
            rows.data_ptr(), out.data_ptr(), rows.shape[0], group,
            torch.cuda.current_stream(out.device).cuda_stream)
        _build.check(code, "wide_rows")
        LAUNCHES["wide_rows_fr"] += 1
    return out


def from_mont(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form (a product with the plain 1)."""
    return mont_mul(ctx, a, ctx.const("std_one", a.device))


def mont_sqr(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, a)


def mont_pow_fixed(ctx: MontCtx, a: torch.Tensor, exp_bits) -> torch.Tensor:
    """a^e for fixed exponent bits, MSB first (`field.limb.mont_pow_fixed`
    with each product on the kernel)."""
    return limb.mont_pow_fixed(ctx, a, exp_bits, mont_mul)


def mont_inv(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) for every element (Montgomery in and out); zero maps to
    zero."""
    return limb.mont_inv(ctx, a, mont_mul)


# ---------------------------------------------------------------------------
# the prefix-product chain
# ---------------------------------------------------------------------------

def _elem(ops, what: str) -> tuple:
    if ops.ctx.p != limb.FQ_CTX.p:
        raise ValueError(f"{what}: the kernel takes Fq and Fq2 only")
    return (L,) if ops.elem_ndim == 1 else (2, L)


def _check_scan(ops, grid: torch.Tensor, carry) -> None:
    elem = _elem(ops, "mont_scan")
    if (grid.dtype != limb.DT or grid.dim() != 2 + len(elem)
            or tuple(grid.shape[2:]) != elem):
        raise ValueError(f"mont_scan needs a (B, c, *{elem}) int32 grid, "
                         f"got {tuple(grid.shape)} {grid.dtype}")
    if carry is not None:
        if carry.device != grid.device:
            raise ValueError(f"mont_scan: carry on {carry.device}, grid on "
                             f"{grid.device}")
        if carry.dtype != limb.DT or carry.shape != grid.shape[:1] + elem:
            raise ValueError(f"mont_scan: carry {tuple(carry.shape)} does "
                             f"not match the grid's rows")
    if grid.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mont_scan: unsupported device {grid.device}")


# threads of a scan block (`kThreads` of csrc/mont_scan.cu): the kernel
# splits a row into this many runs
SCAN_THREADS = 128
# the longest row `curve.jacobian._prefix_prod` gives one scan launch: 16
# products a thread
SCAN_ROW = 16 * SCAN_THREADS


def scan_chunk(n: int) -> int:
    """Elements of a row at a prefix-product level of n elements."""
    return min(SCAN_ROW, n)


def mont_scan_plain(ops, grid: torch.Tensor, carry=None,
                    collect: bool = True):
    """The plain version, split as the kernel splits a row: runs of
    ceil(c / 128) elements, each run's product, the runs' exclusive
    products in order from the carry, then every prefix from its run's
    start; one product per step with every run of every row side by side.
    Products are canonical residues, so the split changes no byte of the
    result: it is the loop along the row, in 2 ceil(c / 128) + 128
    steps instead of c."""
    plain = type(ops)(ops.ctx)          # the plain Montgomery product
    b, c = grid.shape[:2]
    elem, dev = grid.shape[2:], grid.device
    k = -(-c // SCAN_THREADS)           # elements a run
    t = -(-c // k) if c else 0          # runs
    if t * k != c:
        grid = torch.cat([grid, plain.one((b, t * k - c), dev)], 1)
    runs = grid.reshape((b, t, k) + elem)
    local = plain.one((b, t), dev)
    for j in range(k):
        local = plain.mul(local, runs[:, :, j])
    acc = plain.one((b,), dev) if carry is None else carry
    starts = torch.empty_like(local)
    for i in range(t):
        starts[:, i] = acc
        acc = plain.mul(acc, local[:, i])
    if not collect:
        return acc, None
    within = torch.empty_like(runs)
    run = starts
    for j in range(k):
        run = plain.mul(run, runs[:, :, j])
        within[:, :, j] = run
    return acc, within.reshape((b, t * k) + elem)[:, :c]


def _mont_scan_cuda(ops, grid, carry, collect):
    b, c = grid.shape[:2]
    flat = _flat(grid)                 # contiguous, 16-byte aligned limbs
    cflat = None if carry is None else _flat(carry)
    totals = torch.empty(grid.shape[:1] + grid.shape[2:], dtype=limb.DT,
                         device=grid.device)
    within = torch.empty_like(flat).reshape(grid.shape) if collect else None
    if b * c:
        fq2 = ops.elem_ndim == 2
        code = _build.lib("mont_scan.cu").zk_mont_scan(
            int(fq2), flat.data_ptr(),
            None if cflat is None else cflat.data_ptr(),
            None if within is None else within.data_ptr(),
            totals.data_ptr(), b, c,
            torch.cuda.current_stream(grid.device).cuda_stream)
        _build.check(code, "mont_scan")
        LAUNCHES["mont_scan_fq2" if fq2 else "mont_scan_fq"] += 1
    return totals, within


def mont_scan(ops, grid: torch.Tensor, carry=None, collect: bool = True):
    """Inclusive prefix products along axis 1 of a (B, c, *elem) grid of
    Fq (`FqOps`) or Fq2 (`Fq2Ops`) Montgomery residues: row b's running
    product starts from carry[b] (None: the one).  Returns (totals (B,
    *elem), every prefix (B, c, *elem) or None when collect is False).
    One launch on CUDA tensors; the plain version on CPU tensors."""
    _check_scan(ops, grid, carry)
    if grid.device.type == "cuda":
        return _mont_scan_cuda(ops, grid, carry, collect)
    return mont_scan_plain(ops, grid, carry, collect)


# ---------------------------------------------------------------------------
# batch_normalize's pass over the points
# ---------------------------------------------------------------------------

def normalize_plain(ops, x, y, z, pre, suf, tinv):
    """The plain version: zinv_i = pre[i - 1] suf[i + 1] tinv (the one past
    either end), then x zinv^2, y zinv^3 and Z = one, or (one, one, 0)
    where z is zero (the products and selects `batch_normalize` ran
    before the kernel)."""
    plain = type(ops)(ops.ctx)          # the plain Montgomery product
    n = z.shape[0]
    inf = plain.is_zero(z)
    one = plain.one((n,), z.device)
    pre_ex = torch.cat([one[:1], pre[:-1]])          # prod_{j<i} z_j
    suf_ex = torch.cat([suf[1:], one[:1]])           # prod_{j>i} z_j
    zinv = plain.mul(plain.mul(pre_ex, suf_ex), tinv.unsqueeze(0))
    zi2 = plain.mul(zinv, zinv)
    zi3 = plain.mul(zi2, zinv)
    return (plain.select(inf, one, plain.mul(x, zi2)),
            plain.select(inf, one, plain.mul(y, zi3)),
            plain.select(inf, torch.zeros_like(one), one))


def normalize(ops, x, y, z, pre, suf, tinv):
    """Affine-or-infinity coordinates of n Jacobian points (x, y, z), each
    (n, *elem) over Fq (`FqOps`) or Fq2 (`Fq2Ops`), from pre[i] = z_0 ..
    z_i and suf[i] = z_i .. z_{n-1} (an infinite point's z taken as one)
    and tinv (*elem), the inverse of the grand product (see
    `normalize_plain`).  Returns (x', y', z').  One launch on CUDA
    tensors; the plain version on CPU tensors."""
    elem = _elem(ops, "normalize")
    arrays = (x, y, z, pre, suf)
    n = z.shape[0]
    for a in arrays + (tinv,):
        if a.dtype != limb.DT or a.device != z.device:
            raise ValueError(f"normalize: int32 limbs on one device, got "
                             f"{a.dtype} on {a.device} and {z.device}")
    if (any(tuple(a.shape) != (n,) + elem for a in arrays)
            or tuple(tinv.shape) != elem):
        raise ValueError(f"normalize needs (n, *{elem}) points and "
                         f"products and a {elem} inverse, got "
                         f"{[tuple(a.shape) for a in arrays + (tinv,)]}")
    if z.device.type == "cpu":
        return normalize_plain(ops, x, y, z, pre, suf, tinv)
    if z.device.type != "cuda":
        raise ValueError(f"normalize: unsupported device {z.device}")
    ins = [_flat(a) for a in arrays + (tinv,)]
    outs = [torch.empty((n,) + elem, dtype=limb.DT, device=z.device)
            for _ in range(3)]
    if n:
        fq2 = ops.elem_ndim == 2
        code = _build.lib("mont_scan.cu").zk_normalize(
            int(fq2), *(a.data_ptr() for a in ins),
            *(o.data_ptr() for o in outs), n,
            torch.cuda.current_stream(z.device).cuda_stream)
        _build.check(code, "normalize")
        LAUNCHES["normalize_fq2" if fq2 else "normalize_fq"] += 1
    return tuple(outs)
