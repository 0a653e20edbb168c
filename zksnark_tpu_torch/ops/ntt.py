"""Radix-2 NTT / iNTT over BN254 Fr limb tensors — the polynomial engine.

Counterpart of `zksnark_tpu/ops/ntt.py`: the same in-order-output DIT
butterflies on bit-reversed input (bit-identical to its
`_butterflies_unrolled` and scan forms), split into passes.  Stages
s0 .. s0 + k - 1 pair indices that differ only in bits s0 - 1 ..
s0 + k - 2, so they act on independent groups of 2^k elements with
stride 2^(s0 - 1); a pass runs those k stages group by group.  On a CUDA
tensor each pass is one launch of the NTT kernel (`csrc/ntt.cu`), which
holds a group in shared memory and runs each butterfly's twiddle product
(K1's Montgomery product), add and subtract in registers; the first pass
reads its input bit-reversed.  On a CPU tensor the plain version runs the
same passes with the same group and twiddle index arithmetic.  The n^-1,
coset and vanishing multiplies stay elementwise launches of K1
(`ops/montmul.py`).

Coset evaluation (for the quotient h: the vanishing polynomial is the
constant g^n - 1 on the coset g*D) is a pointwise pre/post scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .._device import resolve_device
from ..field import limb, params
from ..field.limb import FR_CTX, MontCtx, sub
from .montmul import mont_mul

L = params.NUM_LIMBS
MAX_PASS_LOG = 10      # a pass runs at most 10 stages: 2^10 elements

# launches of the NTT kernel (one per pass); reset and read by
# chip_smoke.py
LAUNCHES = {"ntt_fr": 0}


def pass_widths(log_n: int) -> tuple:
    """ceil(log_n / 10) passes, their stage counts as even as possible."""
    p = -(-log_n // MAX_PASS_LOG)
    return tuple(log_n // p + (i < log_n % p) for i in range(p))


class DomainTables(NamedTuple):
    """The field-valued domain tables (Montgomery form)."""

    tw_table: torch.Tensor        # (n/2, 8) omega^j
    tw_table_inv: torch.Tensor    # (n/2, 8) omega^-j
    coset_lo: torch.Tensor        # (k, 8) g^b for b < k = 2^ceil(log_n/2)
    coset_hi: torch.Tensor        # (n/k, 8) (g^k)^a
    coset_lo_inv: torch.Tensor    # (k, 8) g^-b
    coset_hi_inv: torch.Tensor    # (n/k, 8) (g^-k)^a
    n_inv_mont: torch.Tensor      # (8,)
    vanishing_inv_mont: torch.Tensor  # (8,)


def _pow_table(base: int, count: int, p: int):
    out = [0] * count
    acc = 1
    for i in range(count):
        out[i] = acc
        acc = acc * base % p
    return out


class Domain:
    """A radix-2 evaluation domain of size n = 2^k in Fr, with coset g;
    its transforms run in passes of `pass_widths(k)` stages."""

    def __init__(self, log_n: int, device, ctx: MontCtx = FR_CTX,
                 coset_gen: int = params.FR_GENERATOR):
        assert 1 <= log_n <= params.FR_TWO_ADICITY
        self.widths = pass_widths(log_n)
        self.ctx = ctx
        self.device = device
        self.log_n = log_n
        self.n = n = 1 << log_n
        p = ctx.p
        self.omega = pow(params.FR_ROOT_OF_UNITY,
                         1 << (params.FR_TWO_ADICITY - log_n), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(n, -1, p)
        self.coset_gen = coset_gen
        self.coset_gen_inv = pow(coset_gen, -1, p)
        # Z_D on the coset is the constant g^n - 1
        self.coset_vanishing = (pow(coset_gen, n, p) - 1) % p
        self.coset_vanishing_inv = pow(self.coset_vanishing, -1, p)
        k = 1 << (-(-log_n // 2))        # k = 2^ceil(log_n/2), k | n
        self.coset_k = k

        def mont(vals):
            return torch.from_numpy(ctx.to_mont_np(vals)).to(device)

        def factors(base):
            return (mont(_pow_table(base, k, p)),
                    mont(_pow_table(pow(base, k, p), n // k, p)))

        lo_f, hi_f = factors(coset_gen)
        lo_i, hi_i = factors(self.coset_gen_inv)
        self.t = DomainTables(
            tw_table=mont(_pow_table(self.omega, max(n // 2, 1), p)),
            tw_table_inv=mont(_pow_table(self.omega_inv, max(n // 2, 1), p)),
            coset_lo=lo_f, coset_hi=hi_f,
            coset_lo_inv=lo_i, coset_hi_inv=hi_i,
            n_inv_mont=mont([self.n_inv])[0],
            vanishing_inv_mont=mont([self.coset_vanishing_inv])[0],
        )


_DOMAINS: dict = {}


def get_domain(log_n: int, device=None) -> Domain:
    """The cached domain of size 2^log_n on `device` (None: the card)."""
    dev = resolve_device(device)
    key = (log_n, str(dev))
    hit = _DOMAINS.get(key)
    if hit is None:
        hit = _DOMAINS[key] = Domain(log_n, dev)
    return hit


def _bitrev(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def butterflies_plain(ctx: MontCtx, log_n: int, tw_table: torch.Tensor,
                      x: torch.Tensor, widths) -> torch.Tensor:
    """The in-order-output DIT butterflies of bit-reversed x, pass by
    pass: at stage s0 + r of a pass of k stages starting at s0, element
    i = (hi, mid, lo) (mid < 2^k, lo < 2^(s0-1)) pairs with its partner
    in bit r of mid, and the twiddle is tw_table[j << (log_n - s0 - r)]
    with j = (mid mod 2^r) 2^(s0-1) + lo, as in the kernel."""
    n = 1 << log_n
    dev = x.device
    x = x[_bitrev(log_n, dev)]
    s0 = 1
    for k in widths:
        lo_n = 1 << (s0 - 1)
        hi_n = n >> (s0 - 1 + k)
        for r in range(k):
            xr = x.reshape(hi_n, 1 << (k - 1 - r), 2, 1 << r, lo_n, L)
            u, v = xr[:, :, 0], xr[:, :, 1]
            j = ((torch.arange(1 << r, device=dev) << (s0 - 1)).unsqueeze(1)
                 | torch.arange(lo_n, device=dev))     # (2^r, lo_n)
            t = limb.mont_mul(ctx, tw_table[j << (log_n - s0 - r)], v)
            x = torch.stack([limb.add(ctx, u, t), limb.sub(ctx, u, t)],
                            dim=2).reshape(n, L)
        s0 += k
    return x


def _butterflies_cuda(ctx: MontCtx, log_n: int, tw_table: torch.Tensor,
                      x: torch.Tensor, widths) -> torch.Tensor:
    if ctx.p != FR_CTX.p:
        raise ValueError("the NTT kernel runs over Fr only")
    n = 1 << log_n
    if x.dtype != limb.DT or tuple(x.shape) != (n, L):
        raise ValueError(f"NTT kernel needs ({n}, {L}) int32 limbs, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x, tw = (t.contiguous() for t in (x, tw_table))
    x, tw = (t.clone() if t.data_ptr() % 16 else t for t in (x, tw))
    out = torch.empty_like(x)
    fn = _build.lib("ntt.cu").zk_ntt_pass
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src, s0 = x, 1
    for k in widths:
        elems = max(1 << k, min(n, 256))
        _build.check(fn(src.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n,
                        s0, k, int(src is x), elems, stream), "ntt pass")
        LAUNCHES["ntt_fr"] += 1
        src, s0 = out, s0 + k
    return out


def butterflies(ctx: MontCtx, log_n: int, tw_table: torch.Tensor,
                x: torch.Tensor, widths) -> torch.Tensor:
    """In-order-output DIT butterflies of x read in bit-reversed order,
    in passes of `widths` stages: one kernel launch per pass on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return _butterflies_cuda(ctx, log_n, tw_table, x, widths)
    if x.device.type == "cpu":
        return butterflies_plain(ctx, log_n, tw_table, x, widths)
    raise ValueError(f"ntt: unsupported device {x.device}")


def ntt(domain: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    """coefficients -> evaluations on the domain (Montgomery in/out)."""
    return butterflies(domain.ctx, domain.log_n, domain.t.tw_table, coeffs,
                       domain.widths)


def intt(domain: Domain, evals: torch.Tensor) -> torch.Tensor:
    """evaluations -> coefficients (Montgomery in/out)."""
    x = butterflies(domain.ctx, domain.log_n, domain.t.tw_table_inv, evals,
                    domain.widths)
    return mont_mul(domain.ctx, x, domain.t.n_inv_mont.unsqueeze(0))


def pow_series(ctx: MontCtx, hi: torch.Tensor, lo: torch.Tensor
               ) -> torch.Tensor:
    """(n, 8) Montgomery powers [g^0 .. g^{n-1}] as ONE outer Montgomery
    product g^(a*k + b) = hi[a] * lo[b] (canonical residues are unique, so
    the association cannot change the result)."""
    m, k = hi.shape[0], lo.shape[0]
    return mont_mul(ctx, hi.unsqueeze(1), lo.unsqueeze(0)).reshape(m * k, L)


def coset_ntt(domain: Domain, coeffs: torch.Tensor,
              coset_pows: torch.Tensor | None = None) -> torch.Tensor:
    """coefficients -> evaluations on the coset g*D."""
    t = domain.t
    if coset_pows is None:
        coset_pows = pow_series(domain.ctx, t.coset_hi, t.coset_lo)
    return ntt(domain, mont_mul(domain.ctx, coeffs, coset_pows))


def coset_intt(domain: Domain, evals: torch.Tensor,
               coset_pows_inv: torch.Tensor | None = None) -> torch.Tensor:
    """evaluations on the coset g*D -> coefficients."""
    t = domain.t
    if coset_pows_inv is None:
        coset_pows_inv = pow_series(domain.ctx, t.coset_hi_inv,
                                    t.coset_lo_inv)
    return mont_mul(domain.ctx, intt(domain, evals), coset_pows_inv)


def divide_by_vanishing(domain: Domain, u_c: torch.Tensor,
                        v_c: torch.Tensor, w_c: torch.Tensor
                        ) -> torch.Tensor:
    """h = (U*V - W) / Z_D given the COEFFICIENTS of the three weighted
    witness polynomials (the prover already has u and v from its own
    iNTTs; the JAX package's version takes evaluations and runs those
    iNTTs again).  Returns h's coefficient vector (length n)."""
    ctx = domain.ctx
    t = domain.t
    cpows = pow_series(ctx, t.coset_hi, t.coset_lo)
    ue = coset_ntt(domain, u_c, cpows)
    ve = coset_ntt(domain, v_c, cpows)
    we = coset_ntt(domain, w_c, cpows)
    num = sub(ctx, mont_mul(ctx, ue, ve), we)
    q = mont_mul(ctx, num, t.vanishing_inv_mont.unsqueeze(0))
    return coset_intt(domain, q)
