"""Field-op adapters that make the point formulas generic over Fq and Fq2.

Counterpart of `zksnark_tpu/curve/field_ops.py`.  Each adapter takes its
base-field Montgomery product as a parameter.  `FQ_OPS` / `FQ2_OPS` use
the plain PyTorch one (`field.limb.mont_mul`): the plain versions of the
point kernels (`ops/curve_kernels.py`) are written over them.
`on_kernel()` gives the same field with its products on the montmul
kernel K1 (`ops.montmul.mont_mul`), for the device path's field work.

Element layout:
    Fq:  (..., 8)      int32 u32-limb Montgomery residues
    Fq2: (..., 2, 8)   c0 = [..., 0, :], c1 = [..., 1, :]
"""

from __future__ import annotations

import torch

from ..field import limb
from ..field.limb import FQ_CTX, MontCtx

L = limb.L


class FqOps:
    elem_ndim = 1

    def __init__(self, ctx: MontCtx = FQ_CTX, mont_mul=limb.mont_mul):
        self.ctx = ctx
        self.mont_mul = mont_mul

    def on_kernel(self):
        """The same field with its products on the montmul kernel K1 (its
        plain version on CPU tensors)."""
        from ..ops.montmul import mont_mul

        return type(self)(self.ctx, mont_mul)

    def mul(self, a, b):
        return self.mont_mul(self.ctx, a, b)

    def sqr(self, a):
        return self.mont_mul(self.ctx, a, a)

    def add(self, a, b):
        return limb.add(self.ctx, a, b)

    def sub(self, a, b):
        return limb.sub(self.ctx, a, b)

    def neg(self, a):
        return limb.neg(self.ctx, a)

    def dbl(self, a):
        return limb.add(self.ctx, a, a)

    def is_zero(self, a):
        return limb.is_zero(a)

    def zero(self, shape=(), device="cpu"):
        return torch.zeros(tuple(shape) + (L,), dtype=limb.DT, device=device)

    def one(self, shape=(), device="cpu"):
        return self.ctx.const("one", device).expand(tuple(shape) + (L,))

    def bmask(self, mask):
        """(...,) bool -> broadcastable over an element."""
        return mask[..., None]

    def select(self, mask, a, b):
        """mask ? a : b (mask shape = batch shape)."""
        return torch.where(self.bmask(mask), a, b)

    # host codecs
    def to_mont_np(self, xs):
        return self.ctx.to_mont_np(xs)

    def from_mont_np(self, arr):
        return self.ctx.from_mont_np(arr)


class Fq2Ops(FqOps):
    """Fq2 = Fq[u]/(u^2+1); 3-multiplication Karatsuba.  The products of
    one formula go through one `mont_mul` call (stacked), which is the
    same arithmetic as three calls.  Add, sub, neg and dbl act limbwise
    per coefficient, as in Fq; `from_mont_np` gives (..., 2) of ints."""

    elem_ndim = 2

    def mul(self, a, b):
        c = self.ctx
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        t = self.mont_mul(c, torch.stack([a0, a1, limb.add(c, a0, a1)]),
                          torch.stack([b0, b1, limb.add(c, b0, b1)]))
        t0, t1, t2 = t[0], t[1], t[2]
        r0 = limb.sub(c, t0, t1)
        r1 = limb.sub(c, limb.sub(c, t2, t0), t1)
        return torch.stack([r0, r1], dim=-2)

    def sqr(self, a):
        c = self.ctx
        a0, a1 = a[..., 0, :], a[..., 1, :]
        r = self.mont_mul(
            c, torch.stack([limb.add(c, a0, a1), limb.add(c, a0, a0)]),
            torch.stack([limb.sub(c, a0, a1), a1]))
        return torch.stack([r[0], r[1]], dim=-2)

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    def zero(self, shape=(), device="cpu"):
        return torch.zeros(tuple(shape) + (2, L), dtype=limb.DT,
                           device=device)

    def one(self, shape=(), device="cpu"):
        one = torch.stack([self.ctx.const("one", device),
                           self.ctx.const("zero", device)])
        return one.expand(tuple(shape) + (2, L))

    def bmask(self, mask):
        return mask[..., None, None]

    # host codecs: values are (c0, c1) int pairs
    def to_mont_np(self, xs):
        import numpy as np

        arr = np.asarray(xs, dtype=object)  # (..., 2)
        limbs = self.ctx.to_mont_np(list(arr.reshape(-1)))
        return limbs.reshape(arr.shape + (L,))


FQ_OPS = FqOps()
FQ2_OPS = Fq2Ops()
