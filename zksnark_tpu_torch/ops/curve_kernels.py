"""K2-K4: complete Jacobian point operations on G1 and G2 — the CUDA
kernels (`csrc/point_ops.cu`, `csrc/point_scan.cu`, `csrc/point_tail.cu`),
their plain PyTorch versions, and the launch counts.

Counterpart of `zksnark_tpu/ops/curve_pallas.py` (`jac_madd`, `jac_add`,
`jac_double` over `_madd_core`, `_add_core`, `_double_core`).  The plain
versions below are those cores written over `curve.field_ops` — the same
formulas, the same order of field operations and the same edge-case
selects — so the kernel, the plain version and the TPU kernel give the
same raw Jacobian coordinates.  (The doubling for P = Q is computed only
when some finite pair needs it, in the plain versions and the kernels
alike: the later selects override it everywhere else.)

Elementwise: `madd` / `add` / `double` broadcast the two points' batch
shapes, flatten them, and launch one thread per point.  `out=` lets a
caller have the kernel write into preallocated contiguous coordinate
tensors.

Chains, one launch each where the JAX package runs a `lax.scan` or
`fori_loop` of kernel launches (`zksnark_tpu/ops/msm.py`):
- `bucket_scan`: the bucket scan of every window of one MSM
  (`_bucket_window_sorted`'s gather, chunked scan with the madd or add
  combine, and scatter of the run-end prefixes into bucket slots);
- `add_scan`: the running sums of a (B, c, ...) grid along its c axis
  (`_scan_chunks` with the add combine), with every prefix if asked;
- `double_n`: k doublings (`_double_n`);
- `horner`: the window sums' Horner tail (`horner_body`);
- `comb`: setup's fixed-base comb encryption, 32 mixed adds a scalar
  from an affine (32, 256) table (`zksnark_tpu/groth16/prover.py`
  `_comb_encrypt_impl`, a `lax.scan` of the madd kernel;
  `csrc/point_comb.cu`).
Their plain versions are the loops of the elementwise plain versions.

The MSM's tail (`csrc/point_tail.cu`):
- `block_scan`: running sums of point columns along axis 0 in blocks of
  T threads x s positions, a block's thread sums scanned in shared
  memory: the chunk carries' prefix scan and the tree sum, one launch a
  level (`block_scan_shape` picks T and s from the level's size).  It
  associates the adds otherwise than the JAX package's
  chunked scans: its sums are other Jacobian representatives of the same
  points, and its plain version runs its own association;
- `add_gather`: the add of rows gathered from two point tables, an index
  < 0 standing for infinity: the bucket ends with their forward fill and
  the block carries' fix-up, each in one launch without materializing
  the gathered or broadcast operands;
- `abel`: the Abel step of one MSM's windows, 2^k (C + T) - R (an add, k
  doublings, the negation and an add), one launch.

Every entry runs its kernel on CUDA tensors (raising if it does not build
or launch) and its plain version on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..curve import jacobian as jac
from ..curve.jacobian import JPoint
from ..utils import profiling

# launches of each kernel entry (`profiling.launch_counts()`)
LAUNCHES = profiling.launch_counter(__name__, (
    f"{op}_{g}" for op in ("madd", "add", "double", "bucket_scan", "add_scan",
                           "double_n", "horner", "comb", "add_gather", "abel",
                           "block_scan")
    for g in ("g1", "g2")))

COMB_WINDOWS, COMB_DIGITS = 32, 256     # 8-bit windows of a 256-bit scalar

# The block scan's block, at most, by elem_ndim (G1, G2): the kernel's
# launch bound, which caps its registers.
BLOCK_SCAN_THREADS = {1: 128, 2: 64}
# The shape `block_scan_shape` picks, for G1 and G2 alike (the fastest on
# the H100 at the tail's shapes, in both groups): a level of ~2^15 threads, two warps a
# scheduler of the 132 SMs, where a level stops waiting on one thread's
# chain of dependent adds and waits on the integer units instead; blocks
# of 64 threads at most, so that 2^15 threads leave few enough block totals
# for one block of the next level; 32 positions a thread at most.
BLOCK_SCAN_LANES = 1 << 15
BLOCK_SCAN_BLOCK = 64
BLOCK_SCAN_STEPS = 32


# ---------------------------------------------------------------------------
# plain versions (the TPU kernels' cores)
# ---------------------------------------------------------------------------

def _double_core(K, x, y, z):
    """dbl-2009-l."""
    a = K.sqr(x)
    b = K.sqr(y)
    c = K.sqr(b)
    d = K.sub(K.sqr(K.add(x, b)), K.add(a, c))
    d = K.dbl(d)
    e = K.add(K.dbl(a), a)
    f = K.sqr(e)
    x3 = K.sub(f, K.dbl(d))
    c8 = K.dbl(K.dbl(K.dbl(c)))
    y3 = K.sub(K.mul(e, K.sub(d, x3)), c8)
    z3 = K.dbl(K.mul(y, z))
    return x3, y3, z3


def _double_affine_core(K, x, y):
    """dbl-2009-l specialized to Z = 1 (Z3 = 2Y)."""
    a = K.sqr(x)
    b = K.sqr(y)
    c = K.sqr(b)
    d = K.dbl(K.sub(K.sqr(K.add(x, b)), K.add(a, c)))
    e = K.add(K.dbl(a), a)
    f = K.sqr(e)
    x3 = K.sub(f, K.dbl(d))
    c8 = K.dbl(K.dbl(K.dbl(c)))
    y3 = K.sub(K.mul(e, K.sub(d, x3)), c8)
    z3 = K.dbl(y)
    return x3, y3, z3


def _needs_double(K, both, pz, qz) -> bool:
    """Whether some row is P = Q with both points finite: only those rows
    keep the doubling (an infinite P or Q is selected over it later)."""
    return bool((both & ~K.is_zero(pz) & ~K.is_zero(qz)).any())


def _finish(K, x3, y3, z3, h_zero, r_zero, px, py, pz, qx, qy, qz):
    """P = -Q -> infinity; Q = inf -> P; P = inf -> Q (in that order)."""
    p_inf = K.is_zero(pz)
    q_inf = K.is_zero(qz)
    cancel = h_zero & ~r_zero & ~p_inf & ~q_inf
    one = K.one(cancel.shape, px.device)
    zero = torch.zeros_like(px)
    x3 = K.select(cancel, one, x3)
    y3 = K.select(cancel, one, y3)
    z3 = K.select(cancel, zero, z3)
    x3 = K.select(q_inf, px, x3)
    y3 = K.select(q_inf, py, y3)
    z3 = K.select(q_inf, pz, z3)
    x3 = K.select(p_inf, qx, x3)
    y3 = K.select(p_inf, qy, y3)
    z3 = K.select(p_inf, qz, z3)
    return JPoint(x3, y3, z3)


def _madd_core(K, px, py, pz, qx, qy, qz):
    """Complete mixed add (madd-2007-bl): Q.z must be 0 or one."""
    z1z1 = K.sqr(pz)
    u2 = K.mul(qx, z1z1)
    s2 = K.mul(K.mul(qy, pz), z1z1)
    h = K.sub(u2, px)                      # U1 = X1 (Z2 = 1)
    hh = K.sqr(h)
    i = K.dbl(K.dbl(hh))
    j = K.mul(h, i)
    rsub = K.sub(s2, py)                   # S1 = Y1
    rr = K.dbl(rsub)
    v = K.mul(px, i)
    x3 = K.sub(K.sub(K.sqr(rr), j), K.dbl(v))
    y3 = K.sub(K.mul(rr, K.sub(v, x3)), K.dbl(K.mul(py, j)))
    z3 = K.mul(K.dbl(pz), h)
    h_zero = K.is_zero(h)
    r_zero = K.is_zero(rsub)
    # P = Q (both finite): double the affine Q
    both = h_zero & r_zero
    if _needs_double(K, both, pz, qz):
        dx, dy, dz = _double_affine_core(K, qx, qy)
        x3 = K.select(both, dx, x3)
        y3 = K.select(both, dy, y3)
        z3 = K.select(both, dz, z3)
    return _finish(K, x3, y3, z3, h_zero, r_zero, px, py, pz, qx, qy, qz)


def _add_core(K, px, py, pz, qx, qy, qz):
    """Complete add-2007-bl; P = Q falls back to dbl-2009-l."""
    z1z1 = K.sqr(pz)
    z2z2 = K.sqr(qz)
    u1 = K.mul(px, z2z2)
    u2 = K.mul(qx, z1z1)
    s1 = K.mul(K.mul(py, qz), z2z2)
    s2 = K.mul(K.mul(qy, pz), z1z1)
    h = K.sub(u2, u1)
    i = K.sqr(K.dbl(h))
    j = K.mul(h, i)
    rsub = K.sub(s2, s1)
    rr = K.dbl(rsub)
    v = K.mul(u1, i)
    x3 = K.sub(K.sub(K.sqr(rr), j), K.dbl(v))
    y3 = K.sub(K.mul(rr, K.sub(v, x3)), K.dbl(K.mul(s1, j)))
    z3 = K.mul(K.sub(K.sqr(K.add(pz, qz)), K.add(z1z1, z2z2)), h)
    h_zero = K.is_zero(h)
    r_zero = K.is_zero(rsub)
    both = h_zero & r_zero
    if _needs_double(K, both, pz, qz):
        dx, dy, dz = _double_core(K, px, py, pz)
        x3 = K.select(both, dx, x3)
        y3 = K.select(both, dy, y3)
        z3 = K.select(both, dz, z3)
    return _finish(K, x3, y3, z3, h_zero, r_zero, px, py, pz, qx, qy, qz)


def _broadcast(ops, *pts):
    e = ops.elem_ndim
    batch = torch.broadcast_shapes(*(p.z.shape[:p.z.dim() - e] for p in pts))
    return [JPoint(*(c.expand(batch + c.shape[c.dim() - e:]) for c in p))
            for p in pts], batch


def madd_plain(ops, p: JPoint, q: JPoint) -> JPoint:
    (p, q), _ = _broadcast(ops, p, q)
    return _madd_core(ops, *p, *q)


def add_plain(ops, p: JPoint, q: JPoint) -> JPoint:
    (p, q), _ = _broadcast(ops, p, q)
    return _add_core(ops, *p, *q)


def double_plain(ops, p: JPoint) -> JPoint:
    return JPoint(*_double_core(ops, *p))


def _filled_infinity(ops, shape, dev) -> JPoint:
    """Infinity points in three writable tensors of their own."""
    return JPoint(*(a.clone(memory_format=torch.contiguous_format)
                    for a in jac.infinity(ops, shape, dev)))


def bucket_scan_plain(ops, pts: JPoint, order: torch.Tensor,
                      d_sorted: torch.Tensor, num_buckets: int, c: int,
                      affine: bool):
    """The bucket scan of W windows over the (n,) table `pts`, given each
    window's sort permutation `order` and sorted digits `d_sorted`
    ((W, n) int64).  Lane (w, k) runs over window w's sorted positions
    [k c, k c + c) (positions at or past n are infinity), one `madd`
    (affine) or `add` per step with every lane side by side, and where a
    position ends its digit's run it writes its running sum to that
    digit's slot.  Returns (slots (W, num_buckets) points, infinity where
    the bucket is empty; bucket_chunk (W, num_buckets) int64, the chunk
    whose lane wrote the slot, else 0; valid (W, num_buckets) bool;
    totals (B, W), each lane's sum), B = ceil(n / c)."""
    W, n = order.shape
    dev = pts.z.device
    b = -(-n // c)
    comb = madd_plain if affine else add_plain
    slots = _filled_infinity(ops, (W, num_buckets), dev)
    bucket_chunk = torch.zeros((W, num_buckets), dtype=torch.int64,
                               device=dev)
    valid = torch.zeros((W, num_buckets), dtype=torch.bool, device=dev)
    first = torch.arange(b, device=dev) * c             # (B,)
    inf = jac.infinity(ops, (W, b), dev)
    acc = inf
    for j in range(c):
        pos = first + j
        live = (pos < n).expand(W, b)
        at = pos.clamp(max=n - 1)
        rows = order[:, at]                             # (W, B)
        q = jac.select(ops, live, JPoint(*(a[rows] for a in pts)), inf)
        acc = comb(ops, acc, q)
        d = d_sorted[:, at]
        nxt = d_sorted[:, (pos + 1).clamp(max=n - 1)]
        end = live & ((pos + 1 == n) | (d != nxt))
        wi, ki = end.nonzero(as_tuple=True)
        di = d[wi, ki]
        for s, a in zip(slots, acc):
            s[wi, di] = a[wi, ki]
        bucket_chunk[wi, di] = ki
        valid[wi, di] = True
    totals = JPoint(*(a.transpose(0, 1).contiguous() for a in acc))
    return slots, bucket_chunk, valid, totals


def add_scan_plain(ops, grid: JPoint, collect: bool):
    """Running sums along axis 1 of a (B, c, *rest) point grid, one add
    per step with every lane side by side.  Returns (totals (B, *rest),
    every inclusive prefix (B, c, *rest) or None)."""
    b, c = grid.z.shape[:2]
    rest = grid.z.shape[2:grid.z.dim() - ops.elem_ndim]
    acc = jac.infinity(ops, (b,) + rest, grid.z.device)
    within = JPoint(*(torch.empty_like(a) for a in grid)) if collect else None
    for j in range(c):
        acc = add_plain(ops, acc, JPoint(*(a[:, j] for a in grid)))
        if collect:
            for w, a in zip(within, acc):
                w[:, j] = a
    return acc, within


def block_scan_shape(n: int, r: int):
    """(threads, steps) of the block scan of n positions in r columns: the
    most steps, a power of two up to BLOCK_SCAN_STEPS, that leave the
    level BLOCK_SCAN_LANES threads or more (one step where it has fewer
    positions), then the fewest threads, a power of two up to
    BLOCK_SCAN_BLOCK, that cover a column."""
    steps = 1
    while steps < BLOCK_SCAN_STEPS and n * r >= 2 * steps * BLOCK_SCAN_LANES:
        steps *= 2
    threads = min(BLOCK_SCAN_BLOCK, 1 << (-(-n // steps) - 1).bit_length())
    return threads, steps


def _threads_axis(p: JPoint, sl) -> JPoint:
    return JPoint(*(a[:, sl] for a in p))


def block_scan_plain(ops, pts: JPoint, collect: bool, threads: int,
                     steps: int):
    """Running sums along axis 0 of (n, *rest) points, in blocks of
    `threads` x `steps` positions of each column.  Thread t of block k
    adds positions k T s + t s, ..., + s - 1 (those below n) in order,
    from infinity; the block's T thread sums are scanned in log2 T
    rounds: round d adds to each sum the one d threads back (collecting:
    every thread's inclusive prefix) or pairs neighbours in a tree (only
    the block's total).  Collecting, each thread then adds all but its
    last position again, in order, from the inclusive prefix of the
    thread before it (infinity for thread 0), and its last position takes
    its own inclusive prefix.  Returns (totals (ceil(n / (T s)), *rest),
    every inclusive prefix within its block (n, *rest) or None): the
    kernel's adds in the kernel's association, so its raw coordinates."""
    e = ops.elem_ndim
    n = pts.z.shape[0]
    rest = tuple(pts.z.shape[1:pts.z.dim() - e])
    dev = pts.z.device
    nblk = -(-n // (threads * steps))
    lanes = (nblk, threads) + rest
    pad = jac.infinity(ops, (nblk * threads * steps - n,) + rest, dev)
    grid = JPoint(*(torch.cat([a, b]).reshape(
        (nblk, threads, steps) + rest + a.shape[a.dim() - e:])
        for a, b in zip(pts, pad)))
    first = torch.arange(nblk * threads, device=dev) * steps
    live = (n - first).clamp(0, steps).reshape(
        (nblk, threads) + (1,) * len(rest)).expand(lanes)

    def step(j):
        return JPoint(*(a[:, :, j] for a in grid))

    acc = jac.infinity(ops, lanes, dev)
    for j in range(steps):
        acc = jac.select(ops, live > j, add_plain(ops, acc, step(j)), acc)
    d = 1
    while d < threads:
        if collect:
            moved = add_plain(ops, _threads_axis(acc, slice(0, threads - d)),
                              _threads_axis(acc, slice(d, threads)))
            acc = JPoint(*(torch.cat([a[:, :d], m], 1)
                           for a, m in zip(acc, moved)))
        else:
            acc = add_plain(ops, _threads_axis(acc, slice(0, None, 2)),
                            _threads_axis(acc, slice(1, None, 2)))
        d *= 2
    totals = JPoint(*(a[:, -1].contiguous() for a in acc))
    if not collect:
        return totals, None
    inclusive = acc
    acc = JPoint(*(torch.cat([b, a[:, :threads - 1]], 1) for a, b in zip(
        inclusive, jac.infinity(ops, (nblk, 1) + rest, dev))))
    within = []
    for j in range(steps):
        if j < steps - 1:
            acc = jac.select(ops, live > j + 1, add_plain(ops, acc, step(j)),
                             acc)
        within.append(jac.select(ops, live == j + 1, inclusive, acc))
    within = JPoint(*(torch.stack(c, 2).reshape(
        (nblk * threads * steps,) + rest + c[0].shape[c[0].dim() - e:])[:n]
        for c in zip(*within)))
    return totals, within


def double_n_plain(ops, p: JPoint, k: int) -> JPoint:
    for _ in range(k):
        p = double_plain(ops, p)
    return p


def horner_plain(ops, sums: JPoint, c: int) -> JPoint:
    """sum_w 2^(c w) sums[w] over axis 0, MSB window first:
    acc = 2^c acc + sums[w]."""
    acc = jac.infinity(ops, sums.z.shape[1:sums.z.dim() - ops.elem_ndim],
                       sums.z.device)
    for w in range(sums.z.shape[0] - 1, -1, -1):
        acc = double_n_plain(ops, acc, c)
        acc = add_plain(ops, acc, JPoint(*(a[w] for a in sums)))
    return acc


def _take(ops, table: JPoint, idx: torch.Tensor) -> JPoint:
    """Rows `idx` of a point table (its batch axes flattened, row-major),
    infinity where idx < 0: shape idx.shape + elem."""
    e = ops.elem_ndim
    rows = idx.clamp(min=0).long()
    got = JPoint(*(a.reshape((-1,) + a.shape[a.dim() - e:])[rows]
                   for a in table))
    return jac.select(ops, idx < 0, jac.infinity(ops, idx.shape,
                                                 idx.device), got)


def add_gather_plain(ops, p: JPoint, pi: torch.Tensor, q: JPoint,
                     qi: torch.Tensor) -> JPoint:
    """P[pi] + Q[qi]: `add_plain` on the gathered rows, an index < 0
    standing for infinity (both < 0: the canonical infinity)."""
    return add_plain(ops, _take(ops, p, pi), _take(ops, q, qi))


def abel_plain(ops, c: JPoint, t: JPoint, r: JPoint, k: int) -> JPoint:
    """2^k (C + T) - R: the add, k doublings, `jacobian.neg` and the add
    of the MSM's Abel step."""
    return add_plain(ops, double_n_plain(ops, add_plain(ops, c, t), k),
                     jac.neg(ops, r))


def comb_digits(scalars_std: torch.Tensor) -> torch.Tensor:
    """(m, 8) standard-form limbs -> (m, 32) int64 little-endian bytes
    (with 8-bit windows the comb windows ARE the bytes)."""
    w = scalars_std.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(0, 32, 8, device=w.device)
    return ((w.unsqueeze(-1) >> sh) & 0xFF).reshape(w.shape[0],
                                                    COMB_WINDOWS)


def comb_plain(ops, table: JPoint, scalars_std: torch.Tensor) -> JPoint:
    """E(s_i) = s_i * base: from infinity, one gather of the window's
    table entries and one mixed add per byte, window 0 first."""
    digits = comb_digits(scalars_std)
    acc = jac.infinity(ops, (digits.shape[0],), scalars_std.device)
    for w in range(COMB_WINDOWS):
        d = digits[:, w]
        acc = madd_plain(ops, acc, JPoint(*(a[w][d] for a in table)))
    return acc


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _elem(ops):
    return (8,) if ops.elem_ndim == 1 else (2, 8)


def _flat(c: torch.Tensor, elem) -> torch.Tensor:
    if c.dtype != torch.int32 or tuple(c.shape[c.dim() - len(elem):]) != elem:
        raise ValueError(f"point kernels need (..., {elem}) int32 limbs, "
                         f"got {tuple(c.shape)} {c.dtype}")
    c = c.reshape(-1, 8 * len(elem)).contiguous()
    if c.data_ptr() % 16:
        c = c.clone()
    return c


def _new(batch, elem, dev) -> JPoint:
    return JPoint(*(torch.empty(tuple(batch) + elem, dtype=torch.int32,
                                device=dev) for _ in range(3)))


def _ptrs(p) -> list:
    return [None] * 3 if p is None else [c.data_ptr() for c in p]


def _call(src: str, op: str, ops, dev, *args) -> None:
    """Launch entry zk_point_<op> of `src` on `dev`'s current stream and
    count it.  args: the pointers and sizes after the g2 flag."""
    g2 = int(ops.elem_ndim == 2)
    fn = getattr(_build.lib(src), f"zk_point_{op}")
    code = fn(g2, *args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"point {op}")
    LAUNCHES[f"{op}_{'g2' if g2 else 'g1'}"] += 1


def _launch(op: str, ops, pts, out):
    pts, batch = _broadcast(ops, *pts)
    elem = _elem(ops)
    ins = [_flat(c, elem) for p in pts for c in p]
    n = ins[0].shape[0]
    if out is None:
        out = _new(batch, elem, ins[0].device)
    for o in out:
        if (o.shape != batch + elem or not o.is_contiguous()
                or o.data_ptr() % 16):
            raise ValueError("out= must be contiguous, aligned, of the "
                             "broadcast shape")
    if n:
        _call("point_ops.cu", op, ops, ins[0].device, *_ptrs(ins[:3]),
              *_ptrs(ins[3:]), *_ptrs(out), n)
    return JPoint(*out)


def _bucket_scan_cuda(ops, pts: JPoint, order, d_sorted, num_buckets: int,
                      c: int, affine: bool):
    elem = _elem(ops)
    W, n = order.shape
    dev = pts.z.device
    if (order.dtype != torch.int64 or d_sorted.dtype != torch.int64
            or d_sorted.shape != order.shape):
        raise ValueError("bucket_scan needs (W, n) int64 order and digits")
    if n >= 1 << 32 or not 0 < num_buckets < 1 << 31 or c < 1:
        raise ValueError(f"bucket_scan: n = {n}, {num_buckets} buckets, "
                         f"c = {c} out of range")
    # each window's digits ascend, so its first and last bound them all
    if W * n and bool(((d_sorted[:, 0] < 0)
                       | (d_sorted[:, -1] >= num_buckets)).any()):
        raise ValueError(f"bucket_scan: a digit outside [0, {num_buckets})")
    table = [_flat(a, elem) for a in pts]
    if table[0].shape[0] != n:
        raise ValueError("bucket_scan: the table and order disagree on n")
    order, d_sorted = order.contiguous(), d_sorted.contiguous()
    slots = _filled_infinity(ops, (W, num_buckets), dev)
    bucket_chunk = torch.zeros((W, num_buckets), dtype=torch.int64,
                               device=dev)
    valid = torch.zeros((W, num_buckets), dtype=torch.bool, device=dev)
    totals = _new((-(-n // c), W), elem, dev)
    if W * n:
        _call("point_scan.cu", "bucket_scan", ops, dev, int(affine),
              *_ptrs(table), order.data_ptr(), d_sorted.data_ptr(),
              *_ptrs(slots), bucket_chunk.data_ptr(), valid.data_ptr(),
              *_ptrs(totals), W, n, c, num_buckets)
    return slots, bucket_chunk, valid, totals


def _add_scan_cuda(ops, grid: JPoint, collect: bool):
    elem = _elem(ops)
    batch = grid.z.shape[:grid.z.dim() - ops.elem_ndim]
    b, c, rest = batch[0], batch[1], batch[2:]
    dev = grid.z.device
    ins = [_flat(a, elem) for a in grid]
    totals = _new((b,) + rest, elem, dev)
    within = _new(batch, elem, dev) if collect else None
    if b * math.prod(rest):
        _call("point_scan.cu", "add_scan", ops, dev, *_ptrs(ins),
              *_ptrs(totals), *_ptrs(within), b, c, math.prod(rest),
              int(collect))
    return totals, within


def _block_scan_cuda(ops, pts: JPoint, collect: bool, threads: int,
                     steps: int):
    elem = _elem(ops)
    batch = pts.z.shape[:pts.z.dim() - ops.elem_ndim]
    n, rest = batch[0], batch[1:]
    dev = pts.z.device
    ins = [_flat(a, elem) for a in pts]
    totals = _new((-(-n // (threads * steps)),) + rest, elem, dev)
    within = _new(batch, elem, dev) if collect else None
    if n * math.prod(rest):
        _call("point_tail.cu", "block_scan", ops, dev, *_ptrs(ins),
              *_ptrs(totals), *_ptrs(within), n, math.prod(rest), threads,
              steps, int(collect))
    return totals, within


def _double_n_cuda(ops, p: JPoint, k: int) -> JPoint:
    elem = _elem(ops)
    ins = [_flat(a, elem) for a in p]
    out = _new(p.z.shape[:p.z.dim() - ops.elem_ndim], elem, p.z.device)
    if ins[0].shape[0]:
        _call("point_ops.cu", "double_n", ops, p.z.device, *_ptrs(ins),
              *_ptrs(out), ins[0].shape[0], k)
    return out


def _horner_cuda(ops, sums: JPoint, c: int) -> JPoint:
    elem = _elem(ops)
    batch = sums.z.shape[:sums.z.dim() - ops.elem_ndim]
    ins = [_flat(a, elem) for a in sums]
    out = _new(batch[1:], elem, sums.z.device)
    if math.prod(batch[1:]):
        _call("point_scan.cu", "horner", ops, sums.z.device, *_ptrs(ins),
              *_ptrs(out), math.prod(batch[1:]), batch[0], c)
    return out


def _comb_cuda(ops, table: JPoint, scalars_std: torch.Tensor) -> JPoint:
    elem = _elem(ops)
    tab = [_flat(a, elem) for a in table]
    sc = scalars_std.contiguous()
    if sc.data_ptr() % 16:
        sc = sc.clone()
    m = sc.shape[0]
    out = _new((m,), elem, sc.device)
    if m:
        fn = _build.lib("point_comb.cu").zk_point_comb
        g2 = int(ops.elem_ndim == 2)
        code = fn(g2, *_ptrs(tab), sc.data_ptr(), *_ptrs(out),
                  m, torch.cuda.current_stream(sc.device).cuda_stream)
        _build.check(code, "point comb")
        LAUNCHES[f"comb_{'g2' if g2 else 'g1'}"] += 1
    return out


def _add_gather_cuda(ops, p: JPoint, pi, q: JPoint, qi) -> JPoint:
    elem = _elem(ops)
    ptab = [_flat(a, elem) for a in p]
    qtab = [_flat(a, elem) for a in q]
    if max(ptab[0].shape[0], qtab[0].shape[0]) >= 1 << 31:
        raise ValueError("add_gather: a table of 2^31 rows or more")
    pi, qi = pi.contiguous(), qi.contiguous()
    out = _new(pi.shape, elem, pi.device)
    if pi.numel():
        _call("point_tail.cu", "add_gather", ops, pi.device, *_ptrs(ptab),
              pi.data_ptr(), *_ptrs(qtab), qi.data_ptr(), *_ptrs(out),
              pi.numel())
    return out


def _abel_cuda(ops, c: JPoint, t: JPoint, r: JPoint, k: int) -> JPoint:
    elem = _elem(ops)
    ins = [_flat(a, elem) for p in (c, t, r) for a in p]
    out = _new(r.z.shape[:r.z.dim() - ops.elem_ndim], elem, r.z.device)
    if ins[0].shape[0]:
        _call("point_tail.cu", "abel", ops, r.z.device, *_ptrs(ins),
              *_ptrs(out), ins[0].shape[0], k)
    return out


def _device(p: JPoint, op: str) -> str:
    dev = p.z.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"point {op}: unsupported device {p.z.device}")
    return dev


def _route(op, plain, ops, pts, out):
    if _device(pts[0], op) == "cuda":
        return _launch(op, ops, pts, out)
    res = plain(ops, *pts)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return JPoint(*out)


def madd(ops, p: JPoint, q: JPoint, out=None) -> JPoint:
    """Complete mixed add; q.z must be 0 or the Montgomery one."""
    return _route("madd", madd_plain, ops, (p, q), out)


def add(ops, p: JPoint, q: JPoint, out=None) -> JPoint:
    return _route("add", add_plain, ops, (p, q), out)


def double(ops, p: JPoint, out=None) -> JPoint:
    return _route("double", double_plain, ops, (p,), out)


def bucket_scan(ops, pts: JPoint, order: torch.Tensor,
                d_sorted: torch.Tensor, num_buckets: int, c: int,
                affine: bool):
    """The bucket scan of every window of one MSM (see
    `bucket_scan_plain`); one launch on CUDA tensors.  Each row of
    `d_sorted` must ascend and each row of `order` be a permutation of
    the table's rows: the kernel checks neither (its wrapper checks the
    digits' range and the arrays' dtype and shape).  affine=True needs
    every Z of `pts` to be 0 or the Montgomery one: the kernel reads only
    whether Z is zero."""
    if _device(pts, "bucket_scan") == "cuda":
        return _bucket_scan_cuda(ops, pts, order, d_sorted, num_buckets, c,
                                 affine)
    return bucket_scan_plain(ops, pts, order, d_sorted, num_buckets, c,
                             affine)


def add_scan(ops, grid: JPoint, collect: bool = False):
    """Running sums along axis 1 of a (B, c, *rest) grid (see
    `add_scan_plain`); one launch on CUDA tensors."""
    if _device(grid, "add_scan") == "cuda":
        return _add_scan_cuda(ops, grid, collect)
    return add_scan_plain(ops, grid, collect)


def block_scan(ops, pts: JPoint, collect: bool, threads: int, steps: int):
    """Running sums along axis 0 of (n, *rest) points in blocks of
    `threads` (a power of two up to BLOCK_SCAN_THREADS) x `steps`
    positions a column (see `block_scan_plain`; `block_scan_shape` picks
    them for a level); one launch on CUDA tensors."""
    most = BLOCK_SCAN_THREADS[ops.elem_ndim]
    if not 0 < threads <= most or threads & (threads - 1) or steps < 1:
        raise ValueError(f"block_scan: {threads} threads (a power of two "
                         f"up to {most}) x {steps} steps")
    if math.prod(pts.z.shape[:pts.z.dim() - ops.elem_ndim]) >= 1 << 31:
        raise ValueError("block_scan: 2^31 or more points")
    if _device(pts, "block_scan") == "cuda":
        return _block_scan_cuda(ops, pts, collect, threads, steps)
    return block_scan_plain(ops, pts, collect, threads, steps)


def double_n(ops, p: JPoint, k: int) -> JPoint:
    """2^k P for every point: k doublings, one launch on CUDA tensors."""
    if k < 0:
        raise ValueError(f"double_n: k = {k} < 0")
    if _device(p, "double_n") == "cuda":
        return _double_n_cuda(ops, p, k)
    return double_n_plain(ops, p, k)


def horner(ops, sums: JPoint, c: int) -> JPoint:
    """sum_w 2^(c w) sums[w] over axis 0 of (W, *batch) window sums, in
    the order of the JAX package's horner_body; one launch on CUDA
    tensors."""
    if _device(sums, "horner") == "cuda":
        return _horner_cuda(ops, sums, c)
    return horner_plain(ops, sums, c)


def add_gather(ops, p: JPoint, pi: torch.Tensor, q: JPoint,
               qi: torch.Tensor) -> JPoint:
    """P[pi] + Q[qi] for every entry of the int32 index tensors `pi` and
    `qi` (one shape; the result has it): rows of the tables `p` and `q`
    with their batch axes flattened, an index < 0 standing for infinity.
    One launch on CUDA tensors; every index must be below its table's
    rows (the kernel does not check)."""
    if pi.dtype != torch.int32 or qi.dtype != torch.int32 \
            or pi.shape != qi.shape:
        raise ValueError(f"add_gather: pi and qi must be int32 of one "
                         f"shape, got {pi.dtype} {tuple(pi.shape)} and "
                         f"{qi.dtype} {tuple(qi.shape)}")
    devs = {a.device for a in (*p, pi, *q, qi)}
    if len(devs) != 1:
        raise ValueError(f"add_gather: tensors on {sorted(map(str, devs))}")
    if _device(p, "add_gather") == "cuda":
        return _add_gather_cuda(ops, p, pi, q, qi)
    return add_gather_plain(ops, p, pi, q, qi)


def abel(ops, c: JPoint, t: JPoint, r: JPoint, k: int) -> JPoint:
    """2^k (C + T) - R for every point of three batches of one shape: the
    Abel step of an MSM's windows (C the last chunk carry, T the last
    chunk total, R the tree sum of the filled bucket ends); one launch on
    CUDA tensors."""
    if k < 0:
        raise ValueError(f"abel: k = {k} < 0")
    shapes = {tuple(a.shape) for p in (c, t, r) for a in p}
    devs = {a.device for p in (c, t, r) for a in p}
    if len(shapes) != 1 or len(devs) != 1:
        raise ValueError(f"abel: C, T and R must share one shape and "
                         f"device, got {sorted(shapes)} on "
                         f"{sorted(map(str, devs))}")
    if _device(r, "abel") == "cuda":
        return _abel_cuda(ops, c, t, r, k)
    return abel_plain(ops, c, t, r, k)


def comb(ops, table: JPoint, scalars_std: torch.Tensor) -> JPoint:
    """E(s_i) = s_i * base for every (m, 8) standard-form scalar, from
    the comb table T[w, d] = d * 2^(8 w) * base ((32, 256) points, each
    affine or infinity): 32 mixed adds a scalar, window 0 first, in the
    order of `comb_plain`; one launch on CUDA tensors."""
    elem = _elem(ops)
    for a in table:
        if (a.dtype != torch.int32 or tuple(a.shape) !=
                (COMB_WINDOWS, COMB_DIGITS) + elem):
            raise ValueError(f"comb: the table needs ({COMB_WINDOWS}, "
                             f"{COMB_DIGITS}, *{elem}) int32 coordinates, "
                             f"got {tuple(a.shape)} {a.dtype}")
    if (scalars_std.dtype != torch.int32 or scalars_std.dim() != 2
            or scalars_std.shape[1] != 8):
        raise ValueError(f"comb: scalars must be (m, 8) int32 limbs, got "
                         f"{tuple(scalars_std.shape)} {scalars_std.dtype}")
    if any(a.device != scalars_std.device for a in table):
        raise ValueError(f"comb: table on {table.z.device}, scalars on "
                         f"{scalars_std.device}")
    if _device(table, "comb") == "cuda":
        return _comb_cuda(ops, table, scalars_std)
    return comb_plain(ops, table, scalars_std)
