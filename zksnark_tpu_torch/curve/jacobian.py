"""Batched Jacobian points, generic over Fq (G1) and Fq2 (G2).

Counterpart of `zksnark_tpu/curve/jacobian.py`.  A point batch is a
`JPoint` (X, Y, Z) of limb tensors with a shared leading batch shape.
Infinity is (one, one, 0): the doubling formula propagates Z = 0, and the
complete add resolves every special case with masks.

`add` / `madd` / `double` go to the CUDA kernels K2-K4 on CUDA tensors
and to their plain versions on CPU tensors (`ops/curve_kernels.py`).
`batch_normalize` brings a batch to affine-or-infinity (Z in {0, one})
with one host inversion; its prefix products run on the K1 chain kernel
(`ops.montmul.mont_scan`), its pass over the points on
`ops.montmul.normalize`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class JPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def infinity(ops, shape=(), device="cpu") -> JPoint:
    one = ops.one(shape, device)
    return JPoint(one, one, ops.zero(shape, device))


def from_affine(ops, x, y) -> JPoint:
    return JPoint(x, y, ops.one(x.shape[:x.dim() - ops.elem_ndim],
                                x.device))


def is_infinity(ops, p: JPoint) -> torch.Tensor:
    return ops.is_zero(p.z)


def select(ops, mask, a: JPoint, b: JPoint) -> JPoint:
    """mask ? a : b (mask shape = batch shape)."""
    return JPoint(ops.select(mask, a.x, b.x), ops.select(mask, a.y, b.y),
                  ops.select(mask, a.z, b.z))


def neg(ops, p: JPoint) -> JPoint:
    return JPoint(p.x, ops.neg(p.y), p.z)


def double(ops, p: JPoint, out=None) -> JPoint:
    """dbl-2009-l; infinity (Z=0) propagates (Z3 = 2YZ = 0)."""
    from ..ops import curve_kernels as ck

    return ck.double(ops, p, out)


def add(ops, p: JPoint, q: JPoint, out=None) -> JPoint:
    """Complete addition: handles P=inf, Q=inf, P=Q, P=-Q."""
    from ..ops import curve_kernels as ck

    return ck.add(ops, p, q, out)


def madd(ops, p: JPoint, q: JPoint, out=None) -> JPoint:
    """Complete mixed addition: q MUST be affine-or-infinity (q.z is the
    Montgomery one, or exactly zero) — the `batch_normalize` invariant."""
    from ..ops import curve_kernels as ck

    return ck.madd(ops, p, q, out)


def _prefix_prod(ops, x):
    """Inclusive prefix products of a (n, elem) field array, as a (b, c)
    grid of rows (c = `ops.montmul.scan_chunk(n)`, the tail padded with
    ones), each pass one `mont_scan` launch: the rows' totals, then (b >
    1) the rows' exclusive carries one level up, then every prefix from
    its row's carry; three launches for SCAN_ROW < n <= SCAN_ROW^2.
    Products are canonical residues, so any chunking gives the JAX
    package's bytes (its c = 64 scan, `jacobian._prefix_prod`)."""
    from ..ops.montmul import mont_scan, scan_chunk

    n = x.shape[0]
    c = scan_chunk(n)
    b = -(-n // c)
    elem = x.shape[1:]
    if b * c != n:
        x = torch.cat([x, ops.one((b * c - n,), x.device)])
    grid = x.reshape((b, c) + elem)
    carry = None
    if b > 1:
        totals, _ = mont_scan(ops, grid, collect=False)
        carry = _prefix_prod(ops, torch.cat([ops.one((1,), x.device),
                                             totals[:-1]]))
    _, within = mont_scan(ops, grid, carry)
    return within.reshape((b * c,) + elem)[:n]


def scan_launches(n: int) -> int:
    """`mont_scan` launches of one `_prefix_prod` of n elements."""
    from ..ops.montmul import scan_chunk

    b = -(-n // scan_chunk(n))
    return 1 if b == 1 else 2 + scan_launches(b)


@torch.inference_mode()
def batch_normalize(ops, p: JPoint) -> JPoint:
    """Batched Jacobian -> affine-or-infinity (Z in {0, one}) with ONE
    field inversion: Montgomery's trick as two prefix-product scans plus
    a single host inverse, then one pass over the points for Z^-1, X Z^-2
    and Y Z^-3 (`ops.montmul.normalize`).  Establishes the precondition
    for `madd`."""
    from ..ops.montmul import normalize

    e = ops.elem_ndim
    batch_shape = p.z.shape[:p.z.dim() - e]
    n = 1
    for s in batch_shape:
        n *= s
    flat = JPoint(*(a.reshape((n,) + a.shape[len(batch_shape):]) for a in p))
    dev = flat.z.device
    inf = ops.is_zero(flat.z)
    z = ops.select(inf, ops.one(flat.z.shape[:1], dev), flat.z)
    pre = _prefix_prod(ops, z)                        # z_0 .. z_i
    suf = _prefix_prod(ops, z.flip(0)).flip(0)        # z_i .. z_{n-1}

    # single host inversion of the grand product
    q = ops.ctx.p
    t = ops.from_mont_np(pre[-1].cpu().numpy())
    try:
        if e == 1:
            tinv = pow(int(t), -1, q)
        else:
            t0, t1 = int(t[0]), int(t[1])
            ni = pow((t0 * t0 + t1 * t1) % q, -1, q)
            tinv = (t0 * ni % q, (-t1) * ni % q)
    except ValueError as err:
        # a non-canonical zero encoding (digits != 0 but value = 0 mod p)
        # passes the exact-digit is_zero screen and zeroes the grand
        # product — possible only with a corrupt/malformed input
        raise ValueError(
            "batch_normalize: grand Z-product is 0 mod p — some point "
            "has a malformed Z encoding (Z = 0 mod p but nonzero "
            "digits), e.g. from a corrupt checkpoint") from err
    tinv_m = torch.from_numpy(ops.to_mont_np([tinv])[0]).to(dev)
    x, y, zz = normalize(ops, flat.x, flat.y, flat.z, pre, suf, tinv_m)
    return JPoint(*(a.reshape(batch_shape + a.shape[1:])
                    for a in (x, y, zz)))


def to_affine_np(ops, p: JPoint):
    """Host conversion of a (possibly batched) JPoint to affine python ints
    (None for infinity).  Proof assembly, IO and tests."""
    q = ops.ctx.p
    xs = ops.from_mont_np(p.x.cpu().numpy())
    ys = ops.from_mont_np(p.y.cpu().numpy())
    zs = ops.from_mont_np(p.z.cpu().numpy())

    def conv(x, y, z):
        if ops.elem_ndim == 1:
            if z == 0:
                return None
            zi = pow(int(z), -1, q)
            return (int(x) * zi * zi % q, int(y) * zi * zi * zi % q)
        z0, z1 = int(z[0]), int(z[1])
        if z0 == 0 and z1 == 0:
            return None
        ni = pow((z0 * z0 + z1 * z1) % q, -1, q)
        zi = (z0 * ni % q, (-z1) * ni % q)

        def m(a, b):
            return ((a[0] * b[0] - a[1] * b[1]) % q,
                    (a[0] * b[1] + a[1] * b[0]) % q)

        zi2 = m(zi, zi)
        zi3 = m(zi2, zi)
        return (m((int(x[0]), int(x[1])), zi2),
                m((int(y[0]), int(y[1])), zi3))

    batch_shape = tuple(p.z.shape[:p.z.dim() - ops.elem_ndim])
    if batch_shape == ():
        return conv(xs, ys, zs)
    out = np.empty(batch_shape, dtype=object)
    flat = out.reshape(-1)
    k = len(batch_shape)
    xf = xs.reshape((-1,) + xs.shape[k:])
    yf = ys.reshape((-1,) + ys.shape[k:])
    zf = zs.reshape((-1,) + zs.shape[k:])
    for i in range(flat.shape[0]):
        flat[i] = conv(xf[i], yf[i], zf[i])
    return out
