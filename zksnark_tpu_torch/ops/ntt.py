"""Radix-2 NTT / iNTT over BN254 Fr limb tensors — the polynomial engine.

Counterpart of `zksnark_tpu/ops/ntt.py`.  The butterflies are the
reshape form of the JAX package's `_butterflies_unrolled` (bit-identical
to its scan form): at stage s the (n, 8) array is viewed as
(n / 2^s, 2^s, 8), the two halves of each block are the butterfly pairs,
and the stage twiddles are a strided slice of one power table.  Every
twiddle, n^-1 and coset multiply runs on the montmul kernel K1
(`ops/montmul.py`); the adds and subtracts are plain PyTorch.

Coset evaluation (for the quotient h: the vanishing polynomial is the
constant g^n - 1 on the coset g*D) is a pointwise pre/post scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..field import params
from ..field.limb import FR_CTX, MontCtx, add, sub
from .montmul import mont_mul

L = params.NUM_LIMBS


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
    """A radix-2 evaluation domain of size n = 2^k in Fr, with coset g."""

    def __init__(self, log_n: int, device, ctx: MontCtx = FR_CTX,
                 coset_gen: int = params.FR_GENERATOR):
        assert 1 <= log_n <= params.FR_TWO_ADICITY
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


def _butterflies(ctx: MontCtx, log_n: int, tw_table: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """In-order-output DIT butterflies given bit-reversed input."""
    n = 1 << log_n
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        m = 1 << s
        xb = x.reshape(n // m, m, L)
        u = xb[:, :half]
        v = xb[:, half:]
        w = tw_table[0:n // 2:n // m]              # omega^(j * n/2^s)
        t = mont_mul(ctx, w.unsqueeze(0), v)
        x = torch.cat([add(ctx, u, t), sub(ctx, u, t)], dim=1).reshape(n, L)
    return x


def ntt(domain: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    """coefficients -> evaluations on the domain (Montgomery in/out)."""
    x = coeffs[_bitrev(domain.log_n, coeffs.device)]
    return _butterflies(domain.ctx, domain.log_n, domain.t.tw_table, x)


def intt(domain: Domain, evals: torch.Tensor) -> torch.Tensor:
    """evaluations -> coefficients (Montgomery in/out)."""
    x = evals[_bitrev(domain.log_n, evals.device)]
    x = _butterflies(domain.ctx, domain.log_n, domain.t.tw_table_inv, x)
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
