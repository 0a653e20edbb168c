"""The device prover: Groth16 setup / prove over limb tensors (NTT + MSM).

Counterpart of `zksnark_tpu/groth16/prover.py` (single device; no mesh).
Gates are laid out on a 2^k subgroup D of Fr*, the vanishing polynomial
is t = x^n - 1, and unused slots hold all-zero constraint rows.

  setup   host powers of the trapdoor x -> one iNTT for the Lagrange
          values -> a segmented field sum per wire -> fixed-base comb
          encryptions (one mixed add per 8-bit digit) -> batch_normalize
  prove   witness x R^2 -> ELL gather-multiply-sum -> iNTTs -> coset-NTT
          quotient -> five Pippenger MSMs (four G1, one G2) -> host
          assembly of A, B, C

Every field product runs on the montmul kernel K1, every point operation
on K2-K4.  Randomness (when not pinned), the proof assembly and the
pairings stay on the host.

Entry points put their tensors on the first CUDA card unless the caller
passes `device="cpu"` to `compile_r1cs`; setup and prove run where the
compiled circuit lives.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..curve import bn254 as hc
from ..curve import jacobian as jac
from ..curve.field_ops import FQ2_OPS, FQ_OPS
from ..curve.jacobian import JPoint
from ..field import params
from ..field.limb import FR_CTX, add as l_add
from ..frontend.r1cs import R1CS
from ..ops import msm as msmod
from ..ops import ntt as nttmod
from ..ops import scans
from ..ops.montmul import from_mont, mont_mul
from .protocol import Proof, SigmaG1, SigmaG2

L = params.NUM_LIMBS


# ---------------------------------------------------------------------------
# Circuit compilation: R1CS -> device tables over a radix-2 domain
# ---------------------------------------------------------------------------

@dataclass
class EllMatrix:
    """Gate-major padded sparse matrix: row g holds the (wire, value) pairs
    contributing to constraint g.  Padding entries point at wire 0 with
    value 0."""

    idx: torch.Tensor   # (n, k) int64 wire indices
    val: torch.Tensor   # (n, k, 8) Montgomery Fr values


@dataclass
class DeviceQAP:
    domain: nttmod.Domain
    u: EllMatrix
    v: EllMatrix
    w: EllMatrix
    num_wires: int
    input: int

    @property
    def n(self) -> int:
        return self.domain.n

    @property
    def device(self) -> torch.device:
        return self.domain.device


def _to_ell(rows: List[List[Tuple[int, int]]], root_index, n: int,
            device) -> EllMatrix:
    """Per-wire sparse rows -> gate-major ELL tables."""
    per_gate: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for wire, points in enumerate(rows):
        for root, value in points:
            per_gate[root_index[root]].append((wire, value))
    k = max(1, max((len(g) for g in per_gate), default=1))
    idx = np.zeros((n, k), dtype=np.int64)
    vals = np.zeros((n, k), dtype=object)
    for g, entries in enumerate(per_gate):
        for j, (wire, value) in enumerate(entries):
            idx[g, j] = wire
            vals[g, j] = value
    return EllMatrix(idx=torch.from_numpy(idx).to(device),
                     val=torch.from_numpy(FR_CTX.to_mont_np(vals)).to(device))


@torch.inference_mode()
def compile_r1cs(r1cs: R1CS, min_log_n: int = 1, device=None) -> DeviceQAP:
    """Lay the constraint system out on the smallest 2^k >= num_gates, on
    `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    n_gates = r1cs.num_gates
    log_n = max(min_log_n, max(1, (n_gates - 1).bit_length()))
    domain = nttmod.get_domain(log_n, dev)
    root_index = {r: i for i, r in enumerate(r1cs.roots)}
    return DeviceQAP(
        domain=domain,
        u=_to_ell(r1cs.u, root_index, domain.n, dev),
        v=_to_ell(r1cs.v, root_index, domain.n, dev),
        w=_to_ell(r1cs.w, root_index, domain.n, dev),
        num_wires=r1cs.num_wires,
        input=r1cs.input,
    )


def domain_roots(domain: nttmod.Domain) -> List[int]:
    """The domain points as python ints (for host cross-checks)."""
    out, acc, p = [], 1, FR_CTX.p
    for _ in range(domain.n):
        out.append(acc)
        acc = acc * domain.omega % p
    return out


# ---------------------------------------------------------------------------
# Device CRS
# ---------------------------------------------------------------------------

@dataclass
class DeviceCRS:
    """Device-resident CRS point sets (every Z is 0 or the Montgomery one)
    plus the small host Sigma parts that verify consumes."""

    xi_g1: JPoint          # n points  E1(x^i)
    xi_t_g1: JPoint        # n-1 points E1(x^i t(x)/delta)
    sum_delta_g1: JPoint   # num_wires - input - 1 points
    xi_g2: JPoint          # n points  E2(x^i)
    sigmag1: SigmaG1       # host (alpha/beta/delta + sum_gamma; xi=None)
    sigmag2: SigmaG2       # host (beta/gamma/delta; xi=None)


def _host_points_to_jac(ops, pts, device) -> JPoint:
    """List of host affine points (or None) -> JPoint batch."""
    zero = 0 if ops.elem_ndim == 1 else (0, 0)
    xs = [zero if p is None else p[0] for p in pts]
    ys = [zero if p is None else p[1] for p in pts]
    inf = torch.tensor([p is None for p in pts], device=device)
    x = torch.from_numpy(ops.to_mont_np(xs)).to(device)
    y = torch.from_numpy(ops.to_mont_np(ys)).to(device)
    z = ops.select(inf, ops.zero((len(pts),), device),
                   ops.one((len(pts),), device))
    return JPoint(x, y, z)


_COMB_BITS = 8
_comb_cache: dict = {}


def _comb_table(ops, base_affine, device) -> JPoint:
    """Host-precomputed fixed-base comb table of shape (n_windows, 2^c):
    T[w, d] = d * 2^(c*w) * base, affine-or-infinity.  Cached per
    (curve, base, device)."""
    key = (ops.elem_ndim, base_affine, str(device))
    hit = _comb_cache.get(key)
    if hit is not None:
        return hit
    addf = hc.g1_add if ops.elem_ndim == 1 else hc.g2_add
    n_win = 256 // _COMB_BITS
    flat = []
    step = base_affine
    for _ in range(n_win):
        row = [None]
        for _ in range(1, 1 << _COMB_BITS):
            row.append(addf(row[-1], step))
        flat.extend(row)
        for _ in range(_COMB_BITS):
            step = addf(step, step)
    pts = _host_points_to_jac(ops, flat, device)
    table = JPoint(*(a.reshape((n_win, 1 << _COMB_BITS) + a.shape[1:])
                     for a in pts))
    _comb_cache[key] = table
    return table


def _digits8(scalars_std: torch.Tensor) -> torch.Tensor:
    """(m, 8) standard-form limbs -> (m, 32) int64 little-endian bytes
    (with 8-bit windows the comb windows ARE the bytes)."""
    w = scalars_std.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(0, 32, 8, device=w.device)
    return ((w.unsqueeze(-1) >> sh) & 0xFF).reshape(w.shape[0], 4 * L)


def _comb_encrypt(ops, table: JPoint, scalars_std: torch.Tensor) -> JPoint:
    """E(s_i) = s_i * base via the comb table: one gather + one mixed add
    per 8-bit digit window (32 adds per element)."""
    digits = _digits8(scalars_std)
    acc = jac.infinity(ops, (digits.shape[0],), scalars_std.device)
    for w in range(digits.shape[1]):
        d = digits[:, w]
        pt = JPoint(table.x[w][d], table.y[w][d], table.z[w][d])
        # comb-table entries are affine-or-infinity -> mixed add
        acc = jac.madd(ops, acc, pt)
    return acc


def _fixed_base_encrypt(ops, base_affine, scalars_std: torch.Tensor
                        ) -> JPoint:
    """Batched fixed-base scalar-mul E(s_i) = s_i * base, normalized so
    every prover MSM can run mixed adds."""
    table = _comb_table(ops, base_affine, scalars_std.device)
    return jac.batch_normalize(ops, _comb_encrypt(ops, table, scalars_std))


def _setup_scalars(domain, num_wires: int, ells, xi_mont, alpha_mont,
                   beta_mont, txd_mont, dinv_mont):
    """All CRS scalar vectors: the Lagrange values at the trapdoor x in ONE
    iNTT (L_g(x) = iNTT(xi)[g]), combined_i = beta*u_i(x) + alpha*v_i(x)
    + w_i(x) per wire as a segmented field sum over the ELL entries, and
    xi_t / sum_delta as pointwise products.  Returns standard-form
    (xi, xi_t, sum_delta scalars)."""
    lag = nttmod.intt(domain, xi_mont)                   # (n, 8) Montgomery

    def prods(ell, scale):
        lg = lag if scale is None else mont_mul(FR_CTX, lag,
                                                scale.unsqueeze(0))
        pr = mont_mul(FR_CTX, ell.val, lg.unsqueeze(1))  # (n, k, 8)
        return pr.reshape(-1, L), ell.idx.reshape(-1)

    (pu, iu), (pv, iv), (pw, iw) = (prods(ells[0], beta_mont),
                                    prods(ells[1], alpha_mont),
                                    prods(ells[2], None))
    combined = scans.field_segment_sums(
        FR_CTX, torch.cat([iu, iv, iw]), torch.cat([pu, pv, pw]),
        num_wires)                                       # (wires, 8) mont
    xi_std = from_mont(FR_CTX, xi_mont)
    xi_t_std = from_mont(
        FR_CTX, mont_mul(FR_CTX, xi_mont[:-1], txd_mont.unsqueeze(0)))
    sum_delta_std = from_mont(
        FR_CTX, mont_mul(FR_CTX, combined, dinv_mont.unsqueeze(0)))
    return xi_std, xi_t_std, sum_delta_std


@torch.inference_mode()
def device_setup(
    dqap: DeviceQAP,
    trapdoor: Optional[Tuple[int, int, int, int, int]] = None,
    rng=None,
) -> DeviceCRS:
    """CRS generation on the device that holds `dqap`: one iNTT for the
    Lagrange values, a segmented field sum for the per-wire combination,
    and batched fixed-base comb scalar-muls for every encryption.  Host
    work is O(sqrt n) bigint powers + O(input) sigma points."""
    dev = dqap.device
    f = FR_CTX.p
    if trapdoor is None:
        r = rng or _random
        trapdoor = tuple(r.randrange(1, f) for _ in range(5))
    alpha, beta, gamma, delta, x = (t % f for t in trapdoor)
    n = dqap.n

    # xi = x^0 .. x^{n-1} as an outer Montgomery product of two host power
    # chains of length ~sqrt(n): xi[a*k + b] = (x^k)^a * x^b
    k = min(1 << (n.bit_length() // 2), n)
    m = n // k
    lo = [1] * k
    for i in range(1, k):
        lo[i] = lo[i - 1] * x % f
    xk = lo[-1] * x % f
    hi = [1] * m
    for i in range(1, m):
        hi[i] = hi[i - 1] * xk % f

    def to_m(vals):
        return torch.from_numpy(FR_CTX.to_mont_np(vals)).to(dev)

    xi_mont = mont_mul(FR_CTX, to_m(hi).unsqueeze(1),
                       to_m(lo).unsqueeze(0)).reshape(n, L)
    t_x = (pow(x, n, f) - 1) % f
    gamma_inv = pow(gamma, -1, f)
    delta_inv = pow(delta, -1, f)

    xi_std, xi_t_std, sum_delta_std = _setup_scalars(
        dqap.domain, dqap.num_wires, (dqap.u, dqap.v, dqap.w), xi_mont,
        to_m([alpha])[0], to_m([beta])[0], to_m([t_x * delta_inv % f])[0],
        to_m([delta_inv])[0])

    g1_base = hc.g1_scalar_mul(hc.G1_GEN_PT, params.ENCRYPT_G1_SCALE)
    g2_base = hc.g2_scalar_mul(hc.G2_GEN, params.ENCRYPT_G2_SCALE)

    # small host parts: sum_gamma needs the first input+1 combined values
    head_ints = FR_CTX.from_limbs_np(
        sum_delta_std[:dqap.input + 1].cpu().numpy())
    sum_gamma = [
        hc.g1_scalar_mul(g1_base, int(c) * delta % f * gamma_inv % f)
        for c in head_ints
    ]
    sigmag1 = SigmaG1(
        alpha=hc.g1_scalar_mul(g1_base, alpha),
        beta=hc.g1_scalar_mul(g1_base, beta),
        delta=hc.g1_scalar_mul(g1_base, delta),
        xi=None, sum_gamma=sum_gamma, sum_delta=None, xi_t=None)
    sigmag2 = SigmaG2(
        beta=hc.g2_scalar_mul(g2_base, beta),
        gamma=hc.g2_scalar_mul(g2_base, gamma),
        delta=hc.g2_scalar_mul(g2_base, delta),
        xi=None)

    return DeviceCRS(
        xi_g1=_fixed_base_encrypt(FQ_OPS, g1_base, xi_std),
        xi_t_g1=_fixed_base_encrypt(FQ_OPS, g1_base, xi_t_std),
        sum_delta_g1=_fixed_base_encrypt(
            FQ_OPS, g1_base, sum_delta_std[dqap.input + 1:]),
        xi_g2=_fixed_base_encrypt(FQ2_OPS, g2_base, xi_std),
        sigmag1=sigmag1, sigmag2=sigmag2)


# ---------------------------------------------------------------------------
# Device prove
# ---------------------------------------------------------------------------

def _weighted_evals(ell: EllMatrix, weights_mont: torch.Tensor
                    ) -> torch.Tensor:
    """Evaluations of sum_i w_i * row_i on the domain: ELL gather-mul-sum."""
    prods = mont_mul(FR_CTX, weights_mont[ell.idx], ell.val)   # (n, k, 8)
    acc = prods[:, 0]
    for j in range(1, prods.shape[1]):
        acc = l_add(FR_CTX, acc, prods[:, j])
    return acc


def _witness_quotient(domain, n_input: int, ells, weights_mont):
    """ELL witness reduction -> iNTT -> coset quotient.  Returns
    standard-form scalar vectors (u, v, h, tail-witness).  Each transform
    runs once: the quotient reuses the u and v coefficients."""
    u_c, v_c, w_c = (nttmod.intt(domain, _weighted_evals(e, weights_mont))
                     for e in ells)
    h_c = nttmod.divide_by_vanishing(domain, u_c, v_c, w_c)
    return (from_mont(FR_CTX, u_c), from_mont(FR_CTX, v_c),
            from_mont(FR_CTX, h_c),
            from_mont(FR_CTX, weights_mont[n_input + 1:]))


def _pad_msm(ops, pts: JPoint, scalars: torch.Tensor, n: int):
    """Pad an MSM instance to exactly n terms (infinity points, zero
    scalars); points and scalars are padded independently."""
    if pts.z.shape[0] < n:
        inf = jac.infinity(ops, (n - pts.z.shape[0],), pts.z.device)
        pts = JPoint(*(torch.cat([a, b]) for a, b in zip(pts, inf)))
    if scalars.shape[0] < n:
        scalars = torch.cat([scalars,
                             scalars.new_zeros((n - scalars.shape[0], L))])
    return pts, scalars


def _prove_core(domain, n_input: int, window_bits: int, ells, crs_arrays,
                weights_mont):
    """Quotient, then the four G1 MSMs (padded to one common size, as in
    the JAX package; their Horner tails in one launch) and the G2 MSM."""
    xi_g1, xi_t_g1, sum_delta_g1, xi_g2 = crs_arrays
    n = domain.n
    u_std, v_std, h_std, wit_std = _witness_quotient(
        domain, n_input, ells, weights_mont)
    wb = window_bits
    m = max(n, sum_delta_g1.z.shape[0], wit_std.shape[0])
    xi_p, u_p = _pad_msm(FQ_OPS, xi_g1, u_std, m)
    _, v_p = _pad_msm(FQ_OPS, xi_g1, v_std, m)
    hp, hs = _pad_msm(FQ_OPS, xi_t_g1, h_std[:n - 1], m)
    dp, ds = _pad_msm(FQ_OPS, sum_delta_g1, wit_std, m)
    # affine=True: DeviceCRS point sets have Z in {0, one}; the four G1
    # MSMs share one Horner launch
    a_g1, b_g1, h_xt, c_delta = msmod.msm_windowed_batch(
        FQ_OPS, [(xi_p, u_p), (xi_p, v_p), (hp, hs), (dp, ds)], wb, True)
    b_g2 = msmod.msm_windowed(FQ2_OPS, xi_g2, v_std, wb, True)
    return a_g1, b_g1, b_g2, h_xt, c_delta


@torch.inference_mode()
def device_prove(
    dqap: DeviceQAP,
    crs: DeviceCRS,
    weights: Sequence[int],
    blinding: Optional[Tuple[int, int]] = None,
    rng=None,
) -> Proof:
    """Full prover: device pipeline + host final assembly."""
    dev = dqap.device
    f = FR_CTX.p
    if blinding is None:
        rr = rng or _random
        blinding = (rr.randrange(1, f), rr.randrange(1, f))
    r, s = (b % f for b in blinding)

    w_full = list(weights) + [0] * (dqap.num_wires - len(weights))
    # standard-form limbs on the host (bytes codec), Montgomery form on
    # the device (one product with R^2)
    w_std = torch.from_numpy(FR_CTX.to_limbs_np(w_full)).to(dev)
    weights_mont = mont_mul(FR_CTX, w_std, FR_CTX.const("r2", dev))

    a_g1, b_g1, b_g2, h_xt, c_delta = _prove_core(
        dqap.domain, dqap.input, msmod.pick_window_bits(dqap.n),
        (dqap.u, dqap.v, dqap.w),
        (crs.xi_g1, crs.xi_t_g1, crs.sum_delta_g1, crs.xi_g2), weights_mont)

    a_aff = jac.to_affine_np(FQ_OPS, a_g1)
    b1_aff = jac.to_affine_np(FQ_OPS, b_g1)
    b2_aff = jac.to_affine_np(FQ2_OPS, b_g2)
    hxt_aff = jac.to_affine_np(FQ_OPS, h_xt)
    cdelta_aff = jac.to_affine_np(FQ_OPS, c_delta)

    sg1, sg2 = crs.sigmag1, crs.sigmag2
    a = hc.g1_add(hc.g1_add(a_aff, sg1.alpha),
                  hc.g1_scalar_mul(sg1.delta, r))
    b = hc.g2_add(hc.g2_add(b2_aff, sg2.beta),
                  hc.g2_scalar_mul(sg2.delta, s))

    c = hc.g1_add(hxt_aff, cdelta_aff)
    c = hc.g1_add(c, hc.g1_scalar_mul(a, s))
    inner = hc.g1_add(hc.g1_add(sg1.beta, b1_aff),
                      hc.g1_scalar_mul(sg1.delta, s))
    c = hc.g1_add(c, hc.g1_scalar_mul(inner, r))
    c = hc.g1_add(c, hc.g1_neg(hc.g1_scalar_mul(sg1.delta, r * s % f)))

    return Proof(a=a, b=b, c=c)
