"""Distributed NTT: the four-step (Bailey) factorization over a mesh.

Counterpart of `zksnark_tpu/parallel/ntt_sharded.py`, with the same
layouts.  An NTT of size n = n1 * n2 becomes

    1. n2 column-NTTs of size n1           (local: columns are sharded)
    2. pointwise twiddle scale w^(j2*k1)   (local)
    3. ONE transpose                       (the all-to-all)
    4. n1 row-NTTs of size n2              (local: rows are now sharded)

With M[j1][j2] = a[n2*j1 + j2] (row-major reshape of the coefficients)
the output is X[k1 + n1*k2] = C[k1][k2]: the result comes back
column-major ("four-step order"); `to_natural` gathers it into natural
order.  Steps 1 and 4 are each one batched launch per pass of the NTT
kernel over the rank's n2/d columns or n1/d rows (`ops.ntt` on a
(B, n, 8) batch), step 2 one launch of K1.

Per rank, over a mesh of d ranks: `ntt_sharded` takes this rank's column
block (n1, n2/d, 8) of M and returns its row block (n1/d, n2, 8) of C;
`intt_sharded` is its inverse.

Derivation: X_{k1+n1 k2} = sum_{j2} w^{j2 k1} w_{n2}^{j2 k2}
                              [ sum_{j1} a_{n2 j1 + j2} w_{n1}^{j1 k1} ].
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..field import limb, params
from ..field.limb import FR_CTX
from ..ops import ntt as nttmod
from ..ops.montmul import mont_mul
from .multihost import Mesh

L = params.NUM_LIMBS


class ShardedDomain:
    """Tables of a size-2^(log_n1 + log_n2) four-step NTT on `device`
    (None: the card): tw[j2][k1] = w^(j2*k1) and its inverse, (n2, n1, 8)
    Montgomery, j2-major so that a rank's twiddles are a slice of rows."""

    def __init__(self, log_n1: int, log_n2: int, device=None):
        dev = resolve_device(device)
        self.device = dev
        self.log_n1, self.log_n2 = log_n1, log_n2
        self.n1, self.n2 = 1 << log_n1, 1 << log_n2
        self.n = self.n1 * self.n2
        self.dom1 = nttmod.get_domain(log_n1, dev)
        self.dom2 = nttmod.get_domain(log_n2, dev)
        self.dom_full = nttmod.get_domain(log_n1 + log_n2, dev)
        self.tw = self._tw_matrix(self.dom_full.t.tw_table)
        self.tw_inv = self._tw_matrix(self.dom_full.t.tw_table_inv)
        self.n_inv_mont = self.dom_full.t.n_inv_mont

    def _tw_matrix(self, half: torch.Tensor) -> torch.Tensor:
        """w^(j2*k1 mod n) gathered from the full power table [w^0 ..
        w^(n-1)], whose upper half is the negated lower half (w^(n/2) =
        -1); canonical residues, so the same limbs as any other way of
        computing the powers."""
        full = torch.cat([half, limb.neg(FR_CTX, half)])[:self.n]
        j2 = torch.arange(self.n2, device=self.device).unsqueeze(1)
        k1 = torch.arange(self.n1, device=self.device)
        return full[(j2 * k1) % self.n]


def _columns_first(sd: ShardedDomain, cols: torch.Tensor,
                   tw_cols: torch.Tensor) -> torch.Tensor:
    """Steps 1-2 on a local column block (n1, n2/d, 8): (n2/d, n1, 8)."""
    block = nttmod.ntt(sd.dom1, cols.transpose(0, 1).contiguous())
    return mont_mul(FR_CTX, block, tw_cols)


def ntt_local_block(sd: ShardedDomain, mesh: Mesh, cols: torch.Tensor,
                    tw_cols: torch.Tensor) -> torch.Tensor:
    """The forward four-step transform of this rank's blocks.  cols:
    (n1, n2/d, 8) M-layout column block; tw_cols: (n2/d, n1, 8) this
    rank's rows of `sd.tw`.  Returns the (n1/d, n2, 8) C-layout row
    block."""
    d = mesh.size
    n1d, n2d = sd.n1 // d, sd.n2 // d
    block = _columns_first(sd, cols, tw_cols)          # (n2/d, n1, 8)
    # step 3, the all-to-all: k1 chunk r goes to rank r, and the j2
    # chunks come back in rank order
    sent = block.reshape(n2d, d, n1d, L).transpose(0, 1)
    got = mesh.all_to_all(sent.contiguous())           # (d, n2/d, n1/d, 8)
    rows = got.reshape(sd.n2, n1d, L).transpose(0, 1).contiguous()
    return nttmod.ntt(sd.dom2, rows)                   # (n1/d, n2, 8)


def intt_local_block(sd: ShardedDomain, mesh: Mesh, rows: torch.Tensor,
                     tw_cols: torch.Tensor) -> torch.Tensor:
    """The inverse four-step transform of this rank's blocks.  rows:
    (n1/d, n2, 8) C-layout row block; tw_cols: (n2/d, n1, 8) this rank's
    rows of `sd.tw_inv`.  Returns the (n1, n2/d, 8) M-layout column
    block."""
    d = mesh.size
    n1d, n2d = sd.n1 // d, sd.n2 // d
    r = nttmod.intt(sd.dom2, rows)                     # (n1/d, n2, 8)
    sent = r.transpose(0, 1).reshape(d, n2d, n1d, L)
    got = mesh.all_to_all(sent.contiguous())           # (d, n2/d, n1/d, 8)
    blk = got.transpose(0, 1).reshape(n2d, sd.n1, L)
    blk = nttmod.intt(sd.dom1, mont_mul(FR_CTX, blk, tw_cols))
    return blk.transpose(0, 1).contiguous()            # (n1, n2/d, 8)


def _check(mesh: Mesh, sd: ShardedDomain) -> None:
    if sd.n1 % mesh.size or sd.n2 % mesh.size:
        raise ValueError(f"a four-step split of {sd.n1} x {sd.n2} does not "
                         f"shard over {mesh.size} ranks")


def local_rows(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """This rank's equal stripe of a table's leading axis."""
    per = table.shape[0] // mesh.size
    return table[mesh.rank * per:(mesh.rank + 1) * per]


def ntt_sharded(mesh: Mesh, sd: ShardedDomain,
                m_local: torch.Tensor) -> torch.Tensor:
    """Four-step NTT over the mesh: this rank's column block (n1, n2/d, 8)
    of M in, its row block (n1/d, n2, 8) of C out, where the full NTT in
    natural order is X[k1 + n1*k2] = C[k1][k2]."""
    _check(mesh, sd)
    return ntt_local_block(sd, mesh, m_local, local_rows(mesh, sd.tw))


def intt_sharded(mesh: Mesh, sd: ShardedDomain,
                 c_local: torch.Tensor) -> torch.Tensor:
    """The inverse of `ntt_sharded`: this rank's row block (n1/d, n2, 8)
    of C in, its column block (n1, n2/d, 8) of M out."""
    _check(mesh, sd)
    return intt_local_block(sd, mesh, c_local, local_rows(mesh, sd.tw_inv))


def to_natural(sd: ShardedDomain, c: torch.Tensor) -> torch.Tensor:
    """(n1, n2, 8) gathered four-step output -> (n, 8) natural order."""
    return c.transpose(0, 1).reshape(sd.n, L)


def from_coeffs(sd: ShardedDomain, a: torch.Tensor) -> torch.Tensor:
    """(n, 8) natural-order coefficients -> (n1, n2, 8) input matrix."""
    return a.reshape(sd.n1, sd.n2, L)


# ---------------------------------------------------------------------------
# contiguous-shard layouts (for co-sharding CRS points with transform output)
# ---------------------------------------------------------------------------

def eval_perm(sd: ShardedDomain, n_dev: int) -> np.ndarray:
    """C-layout: perm[p] = natural evaluation index at contiguous global
    position p when the (n1, n2) matrix is row(k1)-sharded over n_dev
    ranks.  Position p = (rank, k1_local, k2) row-major; index k = k1 +
    n1*k2."""
    n1d = sd.n1 // n_dev
    dev, k1l, k2 = np.meshgrid(
        np.arange(n_dev), np.arange(n1d), np.arange(sd.n2), indexing="ij")
    return ((dev * n1d + k1l) + sd.n1 * k2).reshape(-1).astype(np.int32)


def coeff_perm(sd: ShardedDomain, n_dev: int) -> np.ndarray:
    """M-layout: perm[p] = natural coefficient index at contiguous global
    position p when the (n1, n2) matrix is column(j2)-sharded.  Position
    p = (rank, j1, j2_local) row-major; index j = n2*j1 + j2."""
    n2d = sd.n2 // n_dev
    dev, j1, j2l = np.meshgrid(
        np.arange(n_dev), np.arange(sd.n1), np.arange(n2d), indexing="ij")
    return (sd.n2 * j1 + (dev * n2d + j2l)).reshape(-1).astype(np.int32)
