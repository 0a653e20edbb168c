"""K2-K4: complete Jacobian point operations on G1 and G2 — the CUDA
kernels (`csrc/point_ops.cu`), their plain PyTorch versions, and the
launch counts.

Counterpart of `zksnark_tpu/ops/curve_pallas.py` (`jac_madd`, `jac_add`,
`jac_double` over `_madd_core`, `_add_core`, `_double_core`).  The plain
versions below are those cores written over `curve.field_ops` — the same
formulas, the same order of field operations and the same edge-case
selects — so the kernel, the plain version and the TPU kernel give the
same raw Jacobian coordinates.  (The doubling for P = Q is computed only
when some finite pair needs it, in the plain versions and the kernels
alike: the later selects override it everywhere else.)

`madd` / `add` / `double` broadcast the two points' batch shapes, flatten
them, and launch one thread per point on CUDA tensors; on CPU tensors they
run the plain versions.  `out=` lets a caller have the kernel write into
preallocated contiguous coordinate tensors (the MSM scans collect their
prefixes that way).
"""

from __future__ import annotations

import torch

from .. import _build
from ..curve.jacobian import JPoint

# launches of each kernel; reset and read by chip_smoke.py
LAUNCHES = {f"{op}_{g}": 0 for op in ("madd", "add", "double")
            for g in ("g1", "g2")}


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


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _flat(c: torch.Tensor, elem) -> torch.Tensor:
    if c.dtype != torch.int32 or tuple(c.shape[c.dim() - len(elem):]) != elem:
        raise ValueError(f"point kernels need (..., {elem}) int32 limbs, "
                         f"got {tuple(c.shape)} {c.dtype}")
    c = c.reshape(-1, 8 * len(elem)).contiguous()
    if c.data_ptr() % 16:
        c = c.clone()
    return c


def _launch(op: str, ops, pts, out):
    pts, batch = _broadcast(ops, *pts)
    elem = (8,) if ops.elem_ndim == 1 else (2, 8)
    ins = [_flat(c, elem) for p in pts for c in p]
    n = ins[0].shape[0]
    if out is None:
        out = JPoint(*(torch.empty(batch + elem, dtype=torch.int32,
                                   device=ins[0].device) for _ in range(3)))
    for o in out:
        if (o.shape != batch + elem or not o.is_contiguous()
                or o.data_ptr() % 16):
            raise ValueError("out= must be contiguous, aligned, of the "
                             "broadcast shape")
    if n:
        g2 = int(ops.elem_ndim == 2)
        fn = getattr(_build.lib("point_ops.cu"), f"zk_point_{op}")
        code = fn(g2, *(t.data_ptr() for t in ins),
                  *(o.data_ptr() for o in out), n,
                  torch.cuda.current_stream(ins[0].device).cuda_stream)
        _build.check(code, f"point {op}")
        LAUNCHES[f"{op}_{'g2' if g2 else 'g1'}"] += 1
    return JPoint(*out)


def _route(op, plain, ops, pts, out):
    dev = pts[0].z.device
    if dev.type == "cuda":
        return _launch(op, ops, pts, out)
    if dev.type != "cpu":
        raise ValueError(f"point {op}: unsupported device {dev}")
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
