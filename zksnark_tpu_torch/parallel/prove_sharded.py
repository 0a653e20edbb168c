"""Multi-process Groth16 prove step over a `Mesh`.

Counterpart of `zksnark_tpu/parallel/prove_sharded.py`, in the same
layout:

- **witness reduction** (the split layout: ELL gather-multiply-sum and
  the wide rows' CSR sums): gate-sharded, with the constraint rows taken
  in the four-step NTT's evaluation order (`eval_perm`,
  `EllMatrix.take_rows`), so this rank's reduction output is already its
  C-layout block;
- **quotient**: the four-step transforms of `ntt_sharded`, 3 iNTT ->
  coset scale -> 3 NTT -> pointwise -> 1 iNTT on local blocks: 7
  all-to-alls, never a whole vector gathered;
- **MSMs**: point-sharded (`msm_sharded`): each rank runs its stripe
  through the single-device Pippenger, the one-point partials are
  all-gathered and folded.  The CRS points are taken in the same
  four-step coefficient order (`coeff_perm`) as the quotient's scalars,
  once per prove here (at setup in a production deployment).  The
  blinding folds in as on one device (`groth16.prover`): every rank's
  stripes of A, C - h - c_delta and B2 end in the appended points
  (alpha, beta, delta; beta, delta), with the blinding's scalars on
  rank 0 and zeros on the others.

Every rank holds the whole circuit, witness and CRS going in, and the
same five Jacobian partials coming out: `sharded_prove_step` returns
what the single-device `groth16.prover._prove_core` returns, so the host
assembly of `device_prove` is the same either way.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..curve.field_ops import FQ2_OPS, FQ_OPS
from ..curve.jacobian import JPoint
from ..field import params
from ..field.limb import FR_CTX, sub as l_sub
from ..groth16 import prover as prover_mod
from ..ops import ntt as nttmod
from ..ops.montmul import from_mont, mont_mul
from . import ntt_sharded as nsh
from .msm_sharded import msm_sharded
from .multihost import Mesh

L = params.NUM_LIMBS


def four_step_split(log_n: int, n_dev: int) -> tuple:
    """(log_n1, log_n2): 2^log_n = n1 * n2 with d | n1 and d | n2
    (requires log_n >= 2 log2(d))."""
    log_d = (n_dev - 1).bit_length()
    assert n_dev == 1 << log_d, "mesh size must be a power of two"
    log_n1 = max(log_n // 2, log_d)
    log_n2 = log_n - log_n1
    assert log_n2 >= log_d, (
        f"need domain n >= mesh_size^2 for the four-step split "
        f"(log_n={log_n}, n_dev={n_dev})")
    return log_n1, log_n2


@lru_cache(maxsize=None)
def _sharded_domain(log_n: int, n_dev: int, device=None
                    ) -> nsh.ShardedDomain:
    """The four-step domain of 2^log_n over n_dev ranks
    (`four_step_split`)."""
    return nsh.ShardedDomain(*four_step_split(log_n, n_dev), device)


@lru_cache(maxsize=None)
def _perms(sd: nsh.ShardedDomain, n_dev: int):
    return tuple(torch.from_numpy(p.astype("int64")).to(sd.device)
                 for p in (nsh.eval_perm(sd, n_dev),
                           nsh.coeff_perm(sd, n_dev)))


def _take_pts(pts: JPoint, idx: torch.Tensor) -> JPoint:
    return JPoint(*(a[idx] for a in pts))


def sharded_witness_quotient(mesh: Mesh, domain: nttmod.Domain,
                             n_input: int, num_wires: int, ells,
                             weights_mont: torch.Tensor):
    """The distributed four-step quotient pipeline.  ells: the circuit's
    whole (u, v, w) `EllMatrix` tables (each with its wide rows);
    weights_mont: the whole (wires, 8) Montgomery witness.  Returns this
    rank's stripes of n/d standard-form scalars (u, v, h, wit): u/v/h in
    four-step coefficient-perm order (pair them with coeff_perm-ordered
    CRS points), wit the natural-order witness tail, padded with zeros to
    n."""
    d = mesh.size
    sd = _sharded_domain(domain.log_n, d, domain.device)
    n, n1, n2 = sd.n, sd.n1, sd.n2
    assert num_wires - n_input - 1 <= n, (
        "witness tail longer than the domain; widen the domain")
    ep, cp = _perms(sd, d)
    ep_l, cp_l = nsh.local_rows(mesh, ep), nsh.local_rows(mesh, cp)
    tw_l = nsh.local_rows(mesh, sd.tw)
    tw_inv_l = nsh.local_rows(mesh, sd.tw_inv)

    def evals_c(ell):
        # this rank's gates in eval_perm order: its C-layout block
        e = prover_mod._weighted_evals(ell.take_rows(ep_l), weights_mont)
        return e.reshape(n1 // d, n2, L)

    u_m, v_m, w_m = (nsh.intt_local_block(sd, mesh, evals_c(e), tw_inv_l)
                     for e in ells)

    t = domain.t
    coset_m = nttmod.pow_series(FR_CTX, t.coset_hi, t.coset_lo)[cp_l]
    coset_inv_m = nttmod.pow_series(FR_CTX, t.coset_hi_inv,
                                    t.coset_lo_inv)[cp_l]
    coset_m = coset_m.reshape(n1, n2 // d, L)
    coset_inv_m = coset_inv_m.reshape(n1, n2 // d, L)

    def coset_fwd(m):
        return nsh.ntt_local_block(sd, mesh, mont_mul(FR_CTX, m, coset_m),
                                   tw_l)

    ue, ve, we = coset_fwd(u_m), coset_fwd(v_m), coset_fwd(w_m)
    num = l_sub(FR_CTX, mont_mul(FR_CTX, ue, ve), we)
    q = mont_mul(FR_CTX, num, t.vanishing_inv_mont.unsqueeze(0))
    h_m = mont_mul(FR_CTX, nsh.intt_local_block(sd, mesh, q, tw_inv_l),
                   coset_inv_m)

    # the witness tail, padded to n: this rank's natural stripe
    tail = weights_mont[n_input + 1:num_wires]
    tail = torch.cat([tail, tail.new_zeros((n - tail.shape[0], L))])

    def out(m):
        return from_mont(FR_CTX, m.reshape(n // d, L))

    wit_l = from_mont(FR_CTX, nsh.local_rows(mesh, tail))
    return out(u_m), out(v_m), out(h_m), wit_l


def sharded_prove_step(mesh: Mesh, domain: nttmod.Domain, n_input: int,
                       window_bits: int, ells, sets,
                       weights_mont: torch.Tensor, blind: torch.Tensor,
                       num_wires: int = 0):
    """The multi-process prove step: the Jacobian (A, C - h - c_delta, B2,
    h, c_delta), the same on every rank, ready for host assembly.  sets:
    the CRS's `groth16.prover.ProveSets`; blind: the blinding's limbs
    (`groth16.prover._blinding_limbs`), the same on every rank."""
    n = domain.n
    sd = _sharded_domain(domain.log_n, mesh.size, domain.device)
    _, cp = _perms(sd, mesh.size)
    cp_l = nsh.local_rows(mesh, cp)
    if not num_wires:
        num_wires = weights_mont.shape[0]

    u_std, v_std, h_std, wit_std = sharded_witness_quotient(
        mesh, domain, n_input, num_wires, ells, weights_mont)
    if mesh.rank:
        blind = torch.cat([torch.zeros_like(blind[:8]), blind[8:]])
    a_s, c_s, b_s = (torch.cat(parts) for parts in
                     prover_mod._blinded_scalars(u_std, v_std, blind))

    # this rank's points, in the orders of its scalars, then the appended
    # points; the sets are padded with infinity past n - 1 (xi_t) and the
    # witness tail (sum_delta) (`prove_sets`)
    def appended(k):
        return torch.cat([cp_l, torch.arange(n, n + k, device=cp_l.device)])

    xi_g1_l = _take_pts(sets.xi_g1, appended(3))
    xi_t_l = _take_pts(sets.xi_t_g1, cp_l)
    sum_delta_l = JPoint(*(nsh.local_rows(mesh, a[:n])
                           for a in sets.sum_delta_g1))
    xi_g2_l = _take_pts(sets.xi_g2, appended(2))

    # affine=True: the sets hold the batch_normalize invariant; taking
    # keeps it
    def g1_msm(pts, scalars):
        return msm_sharded(FQ_OPS, mesh, pts, scalars, window_bits,
                           affine=True)

    a_g1 = g1_msm(xi_g1_l, a_s)
    c_g1 = g1_msm(xi_g1_l, c_s)
    h_xt = g1_msm(xi_t_l, h_std)
    c_delta = g1_msm(sum_delta_l, wit_std)
    b_g2 = msm_sharded(FQ2_OPS, mesh, xi_g2_l, b_s, window_bits,
                       affine=True)
    return a_g1, c_g1, b_g2, h_xt, c_delta
