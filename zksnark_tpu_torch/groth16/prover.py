"""The device prover: Groth16 setup / prove over limb tensors (NTT + MSM).

Counterpart of `zksnark_tpu/groth16/prover.py`.  Gates are laid out on
a 2^k subgroup D of Fr*, the vanishing polynomial is t = x^n - 1, and
unused slots hold all-zero constraint rows.

  setup   host powers of the trapdoor x -> one iNTT for the Lagrange
          values -> a segmented field sum per wire -> fixed-base comb
          encryptions (one comb launch: a mixed add per 8-bit digit) ->
          batch_normalize (prefix products on the scan kernel)
  prove   witness x R^2 -> ELL gather-multiply-sum and the wide rows'
          CSR sums -> iNTTs -> coset-NTT
          quotient -> five Pippenger MSMs (four G1, one G2; each one
          window over its CRS set's fixed-base window table, built at
          setup), the blinding (r, s) folded into them -> host assembly
          of A, B, C (affine points and two adds)

Every field product runs on the montmul kernel K1, every point operation
on K2-K4.  Randomness (when not pinned), the proof assembly and the
pairings stay on the host.

The blinding folds into the MSMs by expanding the Groth16 proof,
    A  = alpha + sum_j u_j xi_j + r delta
    B2 = beta  + sum_j v_j xi_j + s delta                   (in G2)
    C  = h + c_delta + s A + r (beta + sum_j v_j xi_j + s delta) - rs delta
       = h + c_delta + sum_j (s u_j + r v_j) xi_j + s alpha + r beta
         + rs delta,
so A, B2 and C - h - c_delta are each one MSM over the xi points with
alpha, beta, delta (G1) or beta, delta (G2) appended (`ProveSets`), the
appended scalars (1, 0, r), (s, r, rs) and (1, s) made per prove.

Entry points put their tensors on the first CUDA card unless the caller
passes `device="cpu"` to `compile_r1cs`; setup and prove run where the
compiled circuit lives.

`mesh=` (a `parallel.multihost.Mesh`) runs setup and prove over several
processes, each rank calling them with the same arguments: setup's comb
encryptions split the scalars into one stripe per rank and all-gather the
normalized points, so every rank holds the whole `DeviceCRS`; prove runs
`parallel.prove_sharded` (the four-step quotient and point-sharded MSMs)
and every rank returns the same proof.  Randomness left to the prover is
drawn on rank 0 and shared.
"""

from __future__ import annotations

import contextlib
import random as _random
import threading
from dataclasses import dataclass, field
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
from ..frontend.r1cs import FlatR1CS
from ..ops import curve_kernels as ck
from ..ops import msm as msmod
from ..ops import ntt as nttmod
from ..ops import scans
from ..ops.montmul import from_mont, mont_mul, mont_mul_add, wide_rows
from ..utils import profiling
from .protocol import Proof, SigmaG1, SigmaG2

L = params.NUM_LIMBS


# ---------------------------------------------------------------------------
# Circuit compilation: R1CS -> device tables over a radix-2 domain
# ---------------------------------------------------------------------------

# A launch of the wide-row kernel weighs as much as this many ELL slots
# read (36 B each: ~38 MB, ~11 us at 3.35 TB/s): rows leave the ELL only
# where that saves more.
WIDE_LAUNCH_SLOTS = 1 << 20


@dataclass
class WideRows:
    """The rows of a matrix wider than its ELL, as CSR: wide row r sums
    val[j] * w[idx[j]] over j in [ptr[r], ptr[r + 1]) into row rows[r]
    (`ops.montmul.wide_rows`), `group` lanes to a row; the rows longest
    first."""

    idx: torch.Tensor    # (nnz,) int32 wire indices
    val: torch.Tensor    # (nnz, 8) Montgomery Fr values
    ptr: torch.Tensor    # (rows + 1,) int64
    rows: torch.Tensor   # (rows,) int64 constraint indices
    group: int

    @property
    def nnz(self) -> int:
        return self.idx.shape[0]


@dataclass
class EllMatrix:
    """Gate-major sparse matrix split by row width: row g's (wire, value)
    pairs in an (n, k0) ELL when the row has at most k0 of them, padding
    entries pointing at wire 0 with value 0; the wider rows (their ELL
    rows all padding) in `wide`, None where there are none."""

    idx: torch.Tensor   # (n, k0) int64 wire indices
    val: torch.Tensor   # (n, k0, 8) Montgomery Fr values
    wide: Optional[WideRows] = None

    def take_rows(self, rows: torch.Tensor) -> "EllMatrix":
        """The matrix of the constraints `rows` (distinct), in that
        order."""
        idx, val, wide = self.idx[rows], self.val[rows], self.wide
        if wide is None:
            return EllMatrix(idx=idx, val=val)
        pos = torch.full((self.idx.shape[0],), -1, dtype=torch.int64,
                         device=rows.device)
        pos[rows] = torch.arange(rows.shape[0], device=rows.device)
        local = pos[wide.rows]
        keep = local >= 0
        counts = wide.ptr[1:] - wide.ptr[:-1]
        entries = torch.repeat_interleave(keep, counts)
        ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[keep], 0)])
        return EllMatrix(idx=idx, val=val, wide=WideRows(
            wide.idx[entries], wide.val[entries], ptr, local[keep],
            wide.group))


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

    @property
    def wide_nonzeros(self) -> int:
        return sum(m.wide.nnz for m in (self.u, self.v, self.w)
                   if m.wide is not None)


def narrow_width(n: int, width_counts: np.ndarray) -> int:
    """k0: the ELL width that reads the fewest slots, where each row
    wider than k0 costs its non-zeros and one slot more, and the wide rows
    a launch (`WIDE_LAUNCH_SLOTS`); width_counts[k] rows have k non-zeros.
    Ties keep the rows in the ELL."""
    widths = np.arange(width_counts.shape[0])
    best, best_cost = max(1, widths[-1]), None
    for k in range(best, 0, -1):
        wide = widths > k
        cost = n * k + int(((widths[wide] + 1) * width_counts[wide]).sum())
        cost += WIDE_LAUNCH_SLOTS if width_counts[wide].any() else 0
        if best_cost is None or cost < best_cost:
            best, best_cost = k, cost
    return best


def _wide_group(widest: int) -> int:
    """Lanes to a wide row: the smallest power of two that leaves the
    widest row at most 8 terms a lane, at most a warp."""
    g = 1
    while g < 32 and widest > 8 * g:
        g *= 2
    return g


def _split_layout(gates: np.ndarray, wires: np.ndarray, vcode: np.ndarray,
                  values: np.ndarray, num_wires: int, n: int, device,
                  counts: dict) -> EllMatrix:
    """One matrix's entries -> the split layout (`EllMatrix`), from flat
    arrays: no Python object a slot.  vcode[e] indexes `values` (the
    Montgomery values, row 0 the padding's zero).  Within a constraint
    the entries are ordered by wire, entries of one wire kept in their
    order.  Adds the layout's numbers to `counts`."""
    nnz = gates.shape[0]
    order = np.argsort(gates * num_wires + wires, kind="stable")
    gates, wires, vcode = gates[order], wires[order], vcode[order]
    width = np.bincount(gates, minlength=n)
    k0 = narrow_width(n, np.bincount(width))
    start = np.concatenate([[0], np.cumsum(width)[:-1]])
    narrow = width[gates] <= k0
    slot = np.arange(nnz) - start[gates]
    idx = np.zeros((n, k0), dtype=np.int64)
    vix = np.zeros((n, k0), dtype=np.int64)
    idx[gates[narrow], slot[narrow]] = wires[narrow]
    vix[gates[narrow], slot[narrow]] = vcode[narrow]
    ell = EllMatrix(idx=torch.from_numpy(idx).to(device),
                    val=torch.from_numpy(values[vix]).to(device))
    wide_rows = np.flatnonzero(width > k0)
    wide_rows = wide_rows[np.argsort(-width[wide_rows], kind="stable")]
    lens = width[wide_rows]
    if wide_rows.size:
        ptr = np.concatenate([[0], np.cumsum(lens)])
        sel = np.repeat(start[wide_rows] - ptr[:-1], lens) + np.arange(
            ptr[-1])
        ell.wide = WideRows(
            idx=torch.from_numpy(wires[sel].astype(np.int32)).to(device),
            val=torch.from_numpy(values[vcode[sel]]).to(device),
            ptr=torch.from_numpy(ptr.astype(np.int64)).to(device),
            rows=torch.from_numpy(wide_rows.astype(np.int64)).to(device),
            group=_wide_group(int(lens[0])))
    narrow_nnz = int(narrow.sum())
    counts["narrow_rows"] += n - wide_rows.size
    counts["wide_rows"] += wide_rows.size
    counts["wide_nonzeros"] += nnz - narrow_nnz
    counts["padded_slots"] += n * k0 - narrow_nnz
    counts["product_slots"] += n * k0 + nnz - narrow_nnz
    return ell


@torch.inference_mode()
def compile_r1cs(r1cs, min_log_n: int = 1, device=None) -> DeviceQAP:
    """Lay the constraint system (an `R1CS`, or a `FlatR1CS`: the same
    layout from flat arrays) out on the smallest 2^k >= num_gates, on
    `device` (None: the CUDA card).  Each of u, v, w is split by row width
    (`EllMatrix`); the layout's numbers go to
    `utils.profiling.set_layout`."""
    dev = resolve_device(device)
    flat = r1cs if isinstance(r1cs, FlatR1CS) else r1cs.flat()
    n_gates = flat.num_gates
    log_n = max(min_log_n, max(1, (n_gates - 1).bit_length()))
    domain = nttmod.get_domain(log_n, dev)
    values = FR_CTX.to_mont_np([0] + list(flat.values))   # 0: padding
    counts = dict.fromkeys(profiling.LAYOUT_COUNTERS[3:], 0)
    mats = [_split_layout(g, w, c + 1, values, flat.num_wires, domain.n,
                          dev, counts) for g, w, c in flat.mats]
    profiling.set_layout(
        **{f"narrow_width_{name}": m.idx.shape[1]
           for name, m in zip("uvw", mats)}, **counts)
    return DeviceQAP(
        domain=domain, u=mats[0], v=mats[1], w=mats[2],
        num_wires=flat.num_wires, input=flat.input)


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
class WindowTables:
    """The prove sets' fixed-base window tables (`ops.msm.window_table`,
    W = `ops.msm.table_windows(window_bits)` blocks, block w = 2^(c w)
    times the set): `g1` those of xi_g1, xi_t_g1 and sum_delta_g1, batch
    shape (3, W, m); `g2` that of xi_g2, (W, n + 2).  Block 0 holds the
    sets themselves."""

    window_bits: int
    g1: JPoint
    g2: JPoint

    def g1_table(self, k: int) -> JPoint:
        """The G1 set k's table as W m rows."""
        return JPoint(*(a[k].reshape((-1,) + a.shape[3:]) for a in self.g1))

    def g2_table(self) -> JPoint:
        return JPoint(*(a.reshape((-1,) + a.shape[2:]) for a in self.g2))


@dataclass
class ProveSets:
    """The point sets of a prove's MSMs, built once per CRS
    (`prove_sets`): xi_g1 followed by alpha, beta, delta, xi_t_g1 and
    sum_delta_g1, each padded with infinity to the four G1 MSMs' common
    size max(n + 3, len(sum_delta_g1)); xi_g2 followed by beta, delta.
    Every Z is 0 or the Montgomery one, as in the CRS.  `tables`: their
    window tables where `prove_sets` built them (the sets are then views
    of the tables' first blocks), else None."""

    xi_g1: JPoint
    xi_t_g1: JPoint
    sum_delta_g1: JPoint
    xi_g2: JPoint
    tables: Optional[WindowTables] = None


@dataclass
class DeviceCRS:
    """Device-resident CRS point sets (every Z is 0 or the Montgomery one)
    plus the small host Sigma parts that verify consumes.  Once
    `prove_sets` has run, the four point sets are views of the first rows
    of its sets (the same shapes and values)."""

    xi_g1: JPoint          # n points  E1(x^i)
    xi_t_g1: JPoint        # n-1 points E1(x^i t(x)/delta)
    sum_delta_g1: JPoint   # num_wires - input - 1 points
    xi_g2: JPoint          # n points  E2(x^i)
    sigmag1: SigmaG1       # host (alpha/beta/delta + sum_gamma; xi=None)
    sigmag2: SigmaG2       # host (beta/gamma/delta; xi=None)
    sets: Optional[ProveSets] = field(default=None, repr=False,
                                      compare=False)
    _tables_decided: bool = field(default=False, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)


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


def _phase(timer, name: str, device):
    """`timer.phase(name)` ended by a synchronize of `device`'s card, or
    nothing when there is no timer."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.phase(name, block_on=torch.empty(0, device=device))


def _fixed_base_encrypt(ops, base_affine, scalars_std: torch.Tensor,
                        mesh=None, timer=None) -> JPoint:
    """Batched fixed-base scalar-mul E(s_i) = s_i * base, normalized so
    every prover MSM can run mixed adds.

    mesh: each rank encrypts and normalizes its stripe of the scalars
    (padded with zeros to a multiple of the mesh size) against the
    replicated table, and the stripes are all-gathered.  Affine
    coordinates are unique, so every rank gets the single-device result
    bit for bit.

    The encryption is one launch of the comb kernel (`ops.curve_kernels.
    comb`: 32 mixed adds a scalar, one per 8-bit window).  timer: a
    `utils.profiling.PhaseTimer` that gets the comb, normalize and (mesh)
    gather phases."""
    dev = scalars_std.device
    table = _comb_table(ops, base_affine, dev)
    n = scalars_std.shape[0]
    sharded = mesh is not None and n > 0
    if sharded:
        m = n + (-n) % mesh.size
        padded = torch.cat([scalars_std, scalars_std.new_zeros((m - n, L))])
        per = m // mesh.size
        scalars_std = padded[mesh.rank * per:(mesh.rank + 1) * per]
    with _phase(timer, "comb", dev):
        pts = ck.comb(ops, table, scalars_std)
    with _phase(timer, "normalize", dev):
        pts = jac.batch_normalize(ops, pts)
    if not sharded:
        return pts
    from ..parallel.msm_sharded import all_gather_points

    with _phase(timer, "gather", dev):
        pts = all_gather_points(mesh, ops, pts)      # (d, per, ...)
    return JPoint(*(a.reshape((m,) + a.shape[2:])[:n] for a in pts))


def _rank0_ints(mesh, vals: Sequence[int]) -> Tuple[int, ...]:
    """Rank 0's values on every rank (vals < 2^256)."""
    if mesh is None or mesh.size == 1:
        return tuple(vals)
    limbs = torch.from_numpy(FR_CTX.to_limbs_np(list(vals)))
    got = mesh.all_gather(limbs.to(mesh.device))[0].cpu().numpy()
    return tuple(int(v) for v in FR_CTX.from_limbs_np(got))


def _setup_scalars(domain, num_wires: int, ells, xi_mont, alpha_mont,
                   beta_mont, txd_mont, dinv_mont):
    """All CRS scalar vectors: the Lagrange values at the trapdoor x in ONE
    iNTT (L_g(x) = iNTT(xi)[g]), combined_i = beta*u_i(x) + alpha*v_i(x)
    + w_i(x) per wire as a segmented field sum over the ELL and wide-row
    entries, and
    xi_t / sum_delta as pointwise products.  Returns standard-form
    (xi, xi_t, sum_delta scalars)."""
    lag = nttmod.intt(domain, xi_mont)                   # (n, 8) Montgomery

    keys, vals = [], []
    for ell, scale in zip(ells, (beta_mont, alpha_mont, None)):
        lg = lag if scale is None else mont_mul(FR_CTX, lag,
                                                scale.unsqueeze(0))
        pr = mont_mul(FR_CTX, ell.val, lg.unsqueeze(1))  # (n, k0, 8)
        keys.append(ell.idx.reshape(-1))
        vals.append(pr.reshape(-1, L))
        if ell.wide is not None:
            wd = ell.wide
            rows = torch.repeat_interleave(wd.rows, wd.ptr[1:] - wd.ptr[:-1])
            keys.append(wd.idx.to(torch.int64))
            vals.append(mont_mul(FR_CTX, wd.val, lg[rows]))
    combined = scans.field_segment_sums(
        FR_CTX, torch.cat(keys), torch.cat(vals),
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
    mesh=None,
    timer=None,
) -> DeviceCRS:
    """CRS generation on the device that holds `dqap`: one iNTT for the
    Lagrange values, a segmented field sum for the per-wire combination,
    and batched fixed-base comb scalar-muls for every encryption.  Host
    work is O(sqrt n) bigint powers + O(input) sigma points.

    mesh: the comb encryptions run sharded over the mesh's ranks (see
    `_fixed_base_encrypt`); every rank returns the whole CRS.

    Without a mesh, setup also builds the prove sets' window tables
    (`prove_sets(tables=True)`).

    timer: a `utils.profiling.PhaseTimer` that gets the setup's phases
    (the scalars, the host sigma points, comb, normalize, mesh gather,
    tables), each ended by a synchronize; None times nothing."""
    dev = dqap.device
    f = FR_CTX.p
    if trapdoor is None:
        r = rng or _random
        trapdoor = _rank0_ints(
            mesh, [r.randrange(1, f) for _ in range(5)])
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

    t_x = (pow(x, n, f) - 1) % f
    gamma_inv = pow(gamma, -1, f)
    delta_inv = pow(delta, -1, f)
    with _phase(timer, "scalars", dev):
        xi_mont = mont_mul(FR_CTX, to_m(hi).unsqueeze(1),
                           to_m(lo).unsqueeze(0)).reshape(n, L)
        xi_std, xi_t_std, sum_delta_std = _setup_scalars(
            dqap.domain, dqap.num_wires, (dqap.u, dqap.v, dqap.w), xi_mont,
            to_m([alpha])[0], to_m([beta])[0],
            to_m([t_x * delta_inv % f])[0], to_m([delta_inv])[0])

    with _phase(timer, "sigma (host)", dev):
        g1_base = hc.g1_scalar_mul(hc.G1_GEN_PT, params.ENCRYPT_G1_SCALE)
        g2_base = hc.g2_scalar_mul(hc.G2_GEN, params.ENCRYPT_G2_SCALE)

        # small host parts: sum_gamma needs the first input+1 combined
        # values
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

    def encrypt(ops, base, scalars):
        return _fixed_base_encrypt(ops, base, scalars, mesh, timer)

    crs = DeviceCRS(
        xi_g1=encrypt(FQ_OPS, g1_base, xi_std),
        xi_t_g1=encrypt(FQ_OPS, g1_base, xi_t_std),
        sum_delta_g1=encrypt(FQ_OPS, g1_base,
                             sum_delta_std[dqap.input + 1:]),
        xi_g2=encrypt(FQ2_OPS, g2_base, xi_std),
        sigmag1=sigmag1, sigmag2=sigmag2)
    if mesh is None:
        with _phase(timer, "tables", dev):
            prove_sets(crs, tables=True)
    else:
        prove_sets(crs)
    return crs


def _stack(ops, parts: Sequence[JPoint], size: int) -> JPoint:
    """The point batches `parts` one after another, padded with infinity
    to `size` points, in one copy."""
    have = sum(p.z.shape[0] for p in parts)
    pad = jac.infinity(ops, (size - have,), parts[0].z.device)
    return JPoint(*(torch.cat(c) for c in zip(*parts, pad)))


def _table_bytes(sets: ProveSets, window_bits: int) -> int:
    """The bytes of the sets' window tables."""
    return msmod.table_windows(window_bits) * sum(
        a.numel() * a.element_size()
        for p in (sets.xi_g1, sets.xi_t_g1, sets.sum_delta_g1, sets.xi_g2)
        for a in p)


def _free_bytes(device) -> Optional[int]:
    """Device memory new tensors can take: the card's free memory and the
    allocator's cached blocks; None off a CUDA card."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _with_tables(sets: ProveSets, window_bits: int) -> ProveSets:
    """The sets with their window tables, the sets now views of the
    tables' first blocks; the three G1 sets' doublings run side by side."""
    g1 = msmod.window_table(FQ_OPS, JPoint(*(torch.stack(c) for c in zip(
        sets.xi_g1, sets.xi_t_g1, sets.sum_delta_g1))), window_bits)
    g2 = msmod.window_table(FQ2_OPS, sets.xi_g2, window_bits)
    return ProveSets(*(JPoint(*(a[k, 0] for a in g1)) for k in range(3)),
                     xi_g2=JPoint(*(a[0] for a in g2)),
                     tables=WindowTables(window_bits, g1, g2))


def prove_sets(crs: DeviceCRS, tables: bool = False) -> ProveSets:
    """The CRS's `ProveSets`, built at the first call (`device_setup` makes
    that call; a CRS loaded or carried from elsewhere makes it at its first
    prove) and kept on `crs`, whose four point sets then become views of
    their first rows: each set is stored once, and no prove copies one.

    tables=True (`device_setup` and `device_prove` without a mesh): the
    first such call also decides, once per CRS, whether the sets get
    their window tables (`WindowTables`, c = `ops.msm.pick_window_bits`
    of n), and builds them if they take at most half of the device
    memory new tensors can take (`_free_bytes`); else the CRS keeps the
    windowed MSMs."""
    with crs._lock:
        sets = crs.sets
        dev = crs.xi_g1.z.device
        n = crs.xi_g1.z.shape[0]
        if sets is None:
            sg1, sg2 = crs.sigmag1, crs.sigmag2
            g1_fixed = _host_points_to_jac(
                FQ_OPS, [sg1.alpha, sg1.beta, sg1.delta], dev)
            g2_fixed = _host_points_to_jac(FQ2_OPS, [sg2.beta, sg2.delta],
                                           dev)
            m = max(n + 3, crs.sum_delta_g1.z.shape[0])
            sets = ProveSets(
                xi_g1=_stack(FQ_OPS, [crs.xi_g1, g1_fixed], m),
                xi_t_g1=_stack(FQ_OPS, [crs.xi_t_g1], m),
                sum_delta_g1=_stack(FQ_OPS, [crs.sum_delta_g1], m),
                xi_g2=_stack(FQ2_OPS, [crs.xi_g2, g2_fixed], n + 2))
        if tables and not crs._tables_decided:
            crs._tables_decided = True
            c = msmod.pick_window_bits(n)
            free = _free_bytes(dev)
            if free is None or 2 * _table_bytes(sets, c) <= free:
                sets = _with_tables(sets, c)
        if sets is not crs.sets:
            for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2"):
                k = getattr(crs, name).z.shape[0]
                setattr(crs, name, JPoint(*(a[:k]
                                            for a in getattr(sets, name))))
            crs.sets = sets
        return sets


# ---------------------------------------------------------------------------
# Device prove
# ---------------------------------------------------------------------------

PROVE_MSMS = 5          # four G1 (A, C - h - c_delta, h, c_delta), one G2


def _ell_sums(ell: EllMatrix, weights_mont: torch.Tensor) -> torch.Tensor:
    """The ELL's part of sum_i w_i * row_i on the domain: gather,
    multiply, sum (a wide row's ELL row is all padding: zero)."""
    prods = mont_mul(FR_CTX, weights_mont[ell.idx], ell.val)  # (n, k0, 8)
    acc = prods[:, 0]
    for j in range(1, prods.shape[1]):
        acc = l_add(FR_CTX, acc, prods[:, j])
    return acc


def _wide_sums(ell: EllMatrix, weights_mont: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """`acc` with the wide rows' sums written over their rows."""
    if ell.wide is None:
        return acc
    wd = ell.wide
    return wide_rows(weights_mont, wd.idx, wd.val, wd.ptr, wd.rows,
                     acc.contiguous(), wd.group)


def _weighted_evals(ell: EllMatrix, weights_mont: torch.Tensor
                    ) -> torch.Tensor:
    """Evaluations of sum_i w_i * row_i on the domain: ELL gather-mul-sum,
    then the wide rows' sums written over their (all-padding) ELL rows."""
    return _wide_sums(ell, weights_mont, _ell_sums(ell, weights_mont))


def _witness_quotient(domain, n_input: int, ells, weights_mont,
                      marks=None):
    """Witness reduction (the split layout) -> iNTT -> coset quotient.
    Returns standard-form scalar vectors (u, v, h, tail-witness).  Each
    transform runs once: the quotient reuses the u and v coefficients.
    The three ELL sums run first, then the three wide-row kernels.
    marks: `utils.profiling.StreamMarks` that get a mark after the ELL
    sums and one after the wide rows (the weighted evaluations' end)."""
    evals = [_ell_sums(e, weights_mont) for e in ells]
    if marks is not None:
        marks.mark()
    evals = [_wide_sums(e, weights_mont, a) for e, a in zip(ells, evals)]
    if marks is not None:
        marks.mark()
    u_c, v_c, w_c = (nttmod.intt(domain, e) for e in evals)
    del evals
    h_c = nttmod.divide_by_vanishing(domain, u_c, v_c, w_c)
    return (from_mont(FR_CTX, u_c), from_mont(FR_CTX, v_c),
            from_mont(FR_CTX, h_c),
            from_mont(FR_CTX, weights_mont[n_input + 1:]))


def _blinding_limbs(r: int, s: int) -> np.ndarray:
    """(10, 8) int32 limbs: the scalars appended to the MSMs of A (1, 0,
    r), of C - h - c_delta (s, r, rs) and of B2 (1, s) in standard form,
    then s and r in Montgomery form."""
    f = FR_CTX.p
    return np.concatenate([
        FR_CTX.to_limbs_np([1, 0, r, s, r, r * s % f, 1, s]),
        FR_CTX.to_mont_np([s, r])])


def _blinded_scalars(u_std, v_std, blind):
    """The folded MSMs' per-term scalars, standard form, each as the parts
    to concatenate: (u | 1, 0, r), (s u + r v | s, r, rs), (v | 1, s).
    s u + r v is one launch (`mont_mul_add`: standard x Montgomery =
    standard)."""
    suv = mont_mul_add(u_std, v_std, blind[8:10])
    return (u_std, blind[0:3]), (suv, blind[3:6]), (v_std, blind[6:8])


def _prove_core(domain, n_input: int, window_bits: int, ells,
                sets: ProveSets, weights_mont, blind, marks=None):
    """Quotient, then the four G1 MSMs over `sets` (padded to one common
    size) and the G2 MSM, the blinding folded in (`_blinding_limbs` on
    the device as `blind`): over the sets' window tables where they have
    them (`ops.msm.msm_tables`), else windowed at `window_bits` (the four
    G1 MSMs' Horner tails in one launch).  Returns the
    Jacobian (A, C - h - c_delta, B2, h, c_delta).  marks:
    `utils.profiling.StreamMarks` that get a mark after the ELL sums, one
    after the wide rows, one after the quotient and one after the G2
    MSM."""
    n = domain.n
    u_std, v_std, h_std, wit_std = _witness_quotient(
        domain, n_input, ells, weights_mont, marks)
    if marks is not None:
        marks.mark()
    m = sets.xi_g1.z.shape[0]
    a_s, c_s, b_s = _blinded_scalars(u_std, v_std, blind)

    def pad(*parts):
        """The parts one after another, zeros to m rows: one copy."""
        k = m - sum(p.shape[0] for p in parts)
        return torch.cat([*parts, parts[0].new_zeros((k, L))])

    tables = sets.tables
    if tables is not None:
        # one window an MSM over the window tables: A and C - h - c_delta
        # share xi_g1's sort and bucket scan, the four G1 MSMs one tail
        a_g1, c_g1, h_xt, c_delta = msmod.msm_tables(FQ_OPS, [
            (tables.g1_table(0), [pad(*a_s), pad(*c_s)]),
            (tables.g1_table(1), [pad(h_std[:n - 1])]),
            (tables.g1_table(2), [pad(wit_std)])], tables.window_bits)
        (b_g2,) = msmod.msm_tables(FQ2_OPS, [
            (tables.g2_table(), [torch.cat(b_s)])], tables.window_bits)
    else:
        # affine=True: the sets' Z are in {0, one}; the four G1 MSMs
        # share one Horner launch
        a_g1, c_g1, h_xt, c_delta = msmod.msm_windowed_batch(
            FQ_OPS, [(sets.xi_g1, pad(*a_s)), (sets.xi_g1, pad(*c_s)),
                     (sets.xi_t_g1, pad(h_std[:n - 1])),
                     (sets.sum_delta_g1, pad(wit_std))], window_bits, True)
        b_g2 = msmod.msm_windowed(FQ2_OPS, sets.xi_g2, torch.cat(b_s),
                                  window_bits, True)
    if marks is not None:
        marks.mark()
    return a_g1, c_g1, b_g2, h_xt, c_delta


@torch.inference_mode()
def device_prove(
    dqap: DeviceQAP,
    crs: DeviceCRS,
    weights: Sequence[int],
    blinding: Optional[Tuple[int, int]] = None,
    rng=None,
    mesh=None,
) -> Proof:
    """Full prover: device pipeline + host final assembly.

    The blinding (r, s), drawn fresh for each call unless pinned, runs on
    the device inside the MSMs (the module's fold); the host only turns
    the five MSM results into affine points and adds three of them.

    mesh: the device pipeline runs the distributed four-step quotient and
    point-sharded MSMs (`parallel.prove_sharded`); the domain must hold
    n >= mesh size^2 (the four-step split).  Every rank returns the same
    proof.

    Spans (`utils.profiling`, where the profiler or `tracing()` is on): a
    root `prove` and its four stages in turn, `prove.encode` (the
    blinding, the witness's limbs on the host, `MontCtx.witness_limbs`;
    its attributes `codec`, "native" or "python", and `reduced_wires`,
    the weights that took Python's `int(x) % p`), `prove.issue` (the
    upload, the Montgomery form and every launch), `prove.wait` (the host
    waiting for the card: one synchronize) and `prove.assemble` (the
    affine points and two adds; its attribute `host_scalar_muls` counts
    the host scalar multiplications run meanwhile); `prove.issue` has
    the attributes `wide_nonzeros`, the non-zeros of the layout's wide
    rows, and `msm_tables`, the prove's MSMs that ran over window tables
    (`PROVE_MSMS` without a mesh where the CRS has them, else 0); on one
    CUDA card also the device spans `quotient` (from before
    the Montgomery form to the quotient's end), `msm` (to the G2 MSM's
    end), `evals` (from before the Montgomery form to the end of the
    three weighted evaluations) and `evals_wide` (from the end of the
    three ELL sums to the end of the three wide-row kernels) from marks
    on the stream."""
    dev = dqap.device
    f = FR_CTX.p
    with profiling.span("prove"):
        with profiling.span("prove.encode", wires=dqap.num_wires) as sp:
            if blinding is None:
                rr = rng or _random
                blinding = _rank0_ints(mesh, [rr.randrange(1, f),
                                              rr.randrange(1, f)])
            r, s = (b % f for b in blinding)
            # standard-form limbs on the host (the witness codec, padded
            # to num_wires), Montgomery form on the device (one product
            # with R^2)
            w_limbs, codec, reduced = FR_CTX.witness_limbs(
                weights, dqap.num_wires)
            blind_limbs = _blinding_limbs(r, s)
            if sp is not None:
                sp.attrs.update(codec=codec, reduced_wires=reduced)

        with profiling.span("prove.issue",
                            wide_nonzeros=dqap.wide_nonzeros) as sp:
            marks = profiling.stream_marks(dev) if mesh is None else None
            w_std = torch.from_numpy(w_limbs).to(dev)
            blind = torch.from_numpy(blind_limbs).to(dev)
            if marks is not None:
                marks.mark()
            weights_mont = mont_mul(FR_CTX, w_std, FR_CTX.const("r2", dev))
            ells = (dqap.u, dqap.v, dqap.w)
            sets = prove_sets(crs, tables=mesh is None)
            if sp is not None:
                sp.attrs["msm_tables"] = (
                    PROVE_MSMS if mesh is None and sets.tables is not None
                    else 0)
            if mesh is None:
                a_g1, c_g1, b_g2, h_xt, c_delta = _prove_core(
                    dqap.domain, dqap.input, msmod.pick_window_bits(dqap.n),
                    ells, sets, weights_mont, blind, marks)
            else:
                from ..parallel import prove_sharded as psh

                window_bits = msmod.pick_window_bits(
                    max(64, dqap.n // mesh.size))
                a_g1, c_g1, b_g2, h_xt, c_delta = psh.sharded_prove_step(
                    mesh, dqap.domain, dqap.input, window_bits, ells,
                    sets, weights_mont, blind, num_wires=dqap.num_wires)

        with profiling.span("prove.wait"):
            if profiling.recording() and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if marks is not None:
            marks.close((("quotient", 0, 3), ("msm", 3, 4),
                         ("evals", 0, 2), ("evals_wide", 1, 2)))

        with profiling.span("prove.assemble") as sp:
            muls = sum(hc.SCALAR_MULS.values())
            a = jac.to_affine_np(FQ_OPS, a_g1)
            b = jac.to_affine_np(FQ2_OPS, b_g2)
            c = hc.g1_add(hc.g1_add(jac.to_affine_np(FQ_OPS, c_g1),
                                    jac.to_affine_np(FQ_OPS, h_xt)),
                          jac.to_affine_np(FQ_OPS, c_delta))
            if sp is not None:
                sp.attrs["host_scalar_muls"] = (
                    sum(hc.SCALAR_MULS.values()) - muls)
            return Proof(a=a, b=b, c=c)
