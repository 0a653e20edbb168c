"""Montgomery field arithmetic on (..., 8) int32 limb tensors — the plain
PyTorch versions, and the host codecs.

Layout: a field element is 8 little-endian u32 limbs of its canonical
Montgomery residue (R = 2^256), stored as the bit patterns of int32 lanes
(PyTorch has no unsigned 32-bit arithmetic).  Batches broadcast across
any leading shape.  Fq2 elements are (..., 2, 8).

These functions are what the CUDA kernels compute (`csrc/bn254_field.cuh`)
and are the kernels' reference: the CPU tests hold them bit-exact to the
JAX package (`zksnark_tpu.field.limb`), and `chip_smoke.py` holds the
kernels bit-exact to them on the card.

PyTorch has no unsigned 64-bit product and a u32 x u32 product overflows
int64, so the plain `mont_mul` works on 16 digits of 16 bits: products
are < 2^32 and 16-term column sums < 2^41, so the three convolutions
(a*b, m = t_lo * n' mod R, m*p) run as float64 matmuls, which are exact
below 2^53, and the carries in int64.  Carries are resolved without a
serial ripple: a few fold passes bring every digit to <= 2^16, after
which generate (d >= 2^16) and propagate (d == 2^16 - 1) are exclusive
and one integer add over the packed bits, ((G << 1) + P) ^ P, yields
every carry at once.  Add and sub use the 32-bit limbs directly (sums
< 2^34 fit int64).
"""

from __future__ import annotations

import numpy as np
import torch

from . import params
from .params import NUM_LIMBS

L = NUM_LIMBS              # 8 u32 limbs
DT = torch.int32
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_JAX_L = params.JAX_NUM_DIGITS


def _limbs_np(x: int) -> np.ndarray:
    return np.frombuffer(int(x).to_bytes(4 * L, "little"), dtype="<i4").copy()


def _digits16_np(x: int) -> np.ndarray:
    return np.array([(x >> (16 * i)) & _M16 for i in range(2 * L)],
                    dtype=np.int64)


def _words32_np(x: int) -> np.ndarray:
    return np.array(params.to_limbs(x), dtype=np.int64)


class MontCtx:
    """Per-modulus constants: host ints, numpy limbs, and device tensors
    built on first use for each device."""

    def __init__(self, p: int):
        self.p = p
        r_mod, r2_mod, n0 = params.mont_constants(p)
        self.r_int = r_mod
        self.n0 = n0          # -p^-1 mod 2^32, the CUDA kernels' constant
        self.nprime_int = (-pow(p, -1, params.MONT_R)) % params.MONT_R
        self._np = {
            "p": _limbs_np(p),
            "one": _limbs_np(r_mod),                      # Montgomery one
            "r2": _limbs_np(r2_mod),
            "std_one": _limbs_np(1),                      # from_mont operand
            "zero": _limbs_np(0),
            "p32": _words32_np(p),
            "pcomp32": _words32_np(params.MONT_R - p),
            "pcomp16": _digits16_np(params.MONT_R - p),
            "nprime_toe": _toeplitz_np(self.nprime_int, 2 * L),
            "p_toe": _toeplitz_np(p, 4 * L),
        }
        self._dev: dict = {}

    def const(self, name: str, device) -> torch.Tensor:
        """Constant `name` as a tensor on `device` (cached)."""
        key = (name, str(device))
        hit = self._dev.get(key)
        if hit is None:
            hit = torch.from_numpy(self._np[name]).to(device)
            self._dev[key] = hit
        return hit

    # -- host codecs ---------------------------------------------------------
    def to_limbs_np(self, xs) -> np.ndarray:
        """ints (any nested list/array) -> (..., 8) int32 limbs of x mod p."""
        arr = np.asarray(xs, dtype=object)
        buf = b"".join((int(x) % self.p).to_bytes(4 * L, "little")
                       for x in arr.reshape(-1))
        out = np.frombuffer(buf, dtype="<i4").astype(np.int32)
        return out.reshape(arr.shape + (L,))

    def from_limbs_np(self, arr) -> np.ndarray:
        """(..., 8) int32 limbs -> object ndarray of python ints."""
        a = np.ascontiguousarray(np.asarray(arr), dtype="<i4")
        out = np.empty(a.shape[:-1], dtype=object)
        oflat = out.reshape(-1)
        raw = a.tobytes()
        w = 4 * L
        for i in range(oflat.shape[0]):
            oflat[i] = int.from_bytes(raw[w * i:w * (i + 1)], "little")
        return out

    def to_mont_np(self, xs) -> np.ndarray:
        arr = np.asarray(xs, dtype=object)
        mont = [(int(x) << 256) % self.p for x in arr.reshape(-1)]
        return self.to_limbs_np(mont).reshape(arr.shape + (L,))

    def from_mont_np(self, arr) -> np.ndarray:
        vals = self.from_limbs_np(arr)
        r_inv = pow(params.MONT_R, -1, self.p)
        flat = vals.reshape(-1)
        for i in range(flat.shape[0]):
            flat[i] = (flat[i] * r_inv) % self.p
        return vals


# ---------------------------------------------------------------------------
# codecs between the port's limbs and the JAX package's f32 digits
# ---------------------------------------------------------------------------

def limbs_from_jax_np(digits) -> np.ndarray:
    """(..., 32) JAX digits (float32, or uint8 for a compressed Z) ->
    (..., 8) int32 limbs: a re-chunk of the same little-endian bytes."""
    d = np.asarray(digits)
    b = np.rint(d).astype(np.uint8) if d.dtype != np.uint8 else d
    b = np.ascontiguousarray(b)
    return b.view("<i4").astype(np.int32).reshape(d.shape[:-1] + (L,))


def limbs_to_jax_np(limbs, dtype=np.float32) -> np.ndarray:
    """(..., 8) int32 limbs -> (..., 32) JAX digits of `dtype`."""
    a = np.ascontiguousarray(np.asarray(limbs), dtype="<i4")
    return a.view(np.uint8).astype(dtype).reshape(a.shape[:-1] + (_JAX_L,))


# ---------------------------------------------------------------------------
# carry machinery (int64 lanes)
# ---------------------------------------------------------------------------

_SHIFTS: dict = {}


def _shifts(k: int, device) -> torch.Tensor:
    key = (k, str(device))
    hit = _SHIFTS.get(key)
    if hit is None:
        hit = torch.arange(k, dtype=torch.int64, device=device)
        _SHIFTS[key] = hit
    return hit


def _resolve(s: torch.Tensor, bits: int, shortcut: bool = False):
    """Resolve single-bit carry chains on base-2^bits digits s (int64).

    Precondition: every digit that can receive a carry is <= 2^(bits+1)-2,
    so generate (s >> bits) and propagate (s == 2^bits - 1) are exclusive.
    Returns (canonical digits, carry out of the top digit)."""
    k = s.shape[-1]
    g = s >> bits
    if shortcut and not s.is_cuda and not bool(g.any()):
        # nothing generates a carry (the common case after fold passes);
        # the test is a host sync, so only CPU tensors take this shortcut
        return s, torch.zeros_like(s[..., 0])
    sh = _shifts(k, s.device)
    p = (s == (1 << bits) - 1).to(torch.int64)
    gw = (g << sh).sum(-1)
    pw = (p << sh).sum(-1)
    x = (gw << 1) + pw
    cin = ((x ^ pw).unsqueeze(-1) >> sh) & 1
    return (s + cin) & ((1 << bits) - 1), (x >> k) & 1


def _fold16(v: torch.Tensor, passes: int) -> torch.Tensor:
    """Fold passes on base-2^16 digits; the top digit's carry is dropped
    (callers only fold values that fit, or want the value mod 2^(16k))."""
    for _ in range(passes):
        hi = v >> 16
        v = v & _M16
        v[..., 1:] += hi[..., :-1]
    return v


def _widen(a: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return a.to(torch.int64) & _M32


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns (the conversion
    keeps the low 32 bits)."""
    return x.to(DT)


def _to16(a: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> 16 int64 digits of 16 bits (little-endian halves)."""
    return a.contiguous().view(torch.int16).to(torch.int64) & _M16


def _from16(d: torch.Tensor) -> torch.Tensor:
    return d.to(torch.int16).view(DT)


_PLACE: dict = {}


def _place(device) -> torch.Tensor:
    """(256, 32) float64 0/1 matrix sending outer-product entry (i, j) to
    column i + j."""
    key = str(device)
    hit = _PLACE.get(key)
    if hit is None:
        n = 2 * L
        m = np.zeros((n * n, 2 * n))
        for i in range(n):
            for j in range(n):
                m[i * n + j, i + j] = 1.0
        hit = _PLACE[key] = torch.from_numpy(m).to(device)
    return hit


def _toeplitz_np(x: int, width: int) -> np.ndarray:
    """(16, width) float64 T[i, k] = digit_{k-i}(x): v @ T is the
    convolution of a 16-digit v with x's 16 digits, cut to `width`."""
    d = _digits16_np(x)
    t = np.zeros((2 * L, width))
    for i in range(2 * L):
        for k in range(i, min(width, i + 2 * L)):
            t[i, k] = d[k - i]
    return t


# ---------------------------------------------------------------------------
# field ops: (..., 8) int32 limbs, canonical [0, p) in and out
# ---------------------------------------------------------------------------

def _two_way(x: torch.Tensor, offset: torch.Tensor):
    """Resolve the word sums x and x + offset together (one stacked
    resolve): a fold pass first, since x + offset can carry 2 per word.
    Returns both canonical word vectors and both carries out of 2^256."""
    x = torch.stack((x, x + offset))
    hi = x >> 32
    x = x & _M32
    x[..., 1:] += hi[..., :-1]                       # words <= 2^32 + 1
    x, co = _resolve(x, 32)
    return x[0], x[1], (co + hi[..., -1]) > 0


def add(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p: a + b and a + b - p (as a + b + 2^256 - p) side by
    side; the second's carry out says a + b >= p."""
    s, d, ge = _two_way(_widen(a) + _widen(b),
                        ctx.const("pcomp32", a.device))
    return _narrow(torch.where(ge[1].unsqueeze(-1), d, s))


def sub(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p via two's complement: a + ~b + 1, whose carry out
    means no borrow; on a borrow the answer is that plus p (mod 2^256)."""
    v = _widen(a) + (_M32 - _widen(b))
    v[..., :1] += 1
    d, plus_p, co = _two_way(v, ctx.const("p32", a.device))
    return _narrow(torch.where(co[0].unsqueeze(-1), d, plus_p))


def neg(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    return sub(ctx, torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p (separated operand scanning on
    16-bit digits; see the module docstring for the bounds)."""
    a, b = torch.broadcast_tensors(a, b)
    dev = a.device
    f64 = torch.float64
    # t = a*b: outer product of the digits, summed along anti-diagonals
    # by one matmul (products < 2^32 and column sums < 2^36 are exact in
    # float64)
    prod = _to16(a).to(f64).unsqueeze(-1) * _to16(b).to(f64).unsqueeze(-2)
    t = (prod.flatten(-2) @ _place(dev)).to(torch.int64)        # < 2^36
    # m = t_lo * n' mod R on the unnormalized columns, split into 16-bit
    # halves so each float64 matmul stays exact (< 2^41)
    tl = t[..., :2 * L]
    npt = ctx.const("nprime_toe", dev)
    m = ((tl & _M16).to(f64) @ npt).to(torch.int64) + (
        ((tl >> 16).to(f64) @ npt).to(torch.int64) << 16)      # < 2^58
    m, _ = _resolve(_fold16(m, 4), 16, shortcut=True)
    s = t + (m.to(f64) @ ctx.const("p_toe", dev)).to(torch.int64)
    s, _ = _resolve(_fold16(s, 3), 16, shortcut=True)  # t + mp < 2^512
    res = s[..., 2 * L:]                              # (t + mp) / R < 2p
    d, ge = _resolve(res + ctx.const("pcomp16", dev), 16)
    return _from16(torch.where(ge.unsqueeze(-1).bool(), d, res))


def to_mont(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, ctx.const("r2", a.device))


def from_mont(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, ctx.const("std_one", a.device))


# Shared contexts
FR_CTX = MontCtx(params.R)
FQ_CTX = MontCtx(params.Q)
