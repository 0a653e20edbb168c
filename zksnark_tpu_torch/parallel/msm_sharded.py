"""Multi-process MSM: each rank runs its stripe of points and scalars
through the single-device Pippenger, then the one-point partials are
all-gathered and folded.

Counterpart of `zksnark_tpu/parallel/msm_sharded.py`.  A rank holds its
stripe going in and the whole sum coming out: every rank folds the same
gathered partials in the same order, so every rank returns the same
point.  Curve points have no reduction collective; the gather moves one
point (X, Y, Z) per rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..curve.jacobian import JPoint
from ..ops import msm as msmod
from .multihost import Mesh, mesh_of


def make_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """The mesh over the first n_devices ranks of the world (all of them
    when None).  Every rank of the world must call it; a rank outside the
    sub-group gets None."""
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return mesh_of(None, world)
    if not 1 <= n_devices <= world:
        raise ValueError(f"make_mesh({n_devices}) on a world of {world}")
    group = dist.new_group(ranks=list(range(n_devices)))
    if dist.get_rank() >= n_devices:
        return None
    return mesh_of(group, n_devices)


def shard_points(mesh: Mesh, pts: JPoint) -> JPoint:
    """This rank's equal contiguous stripe of a point batch (N must be
    divisible by the mesh size)."""
    n = pts.z.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} points do not split over {mesh.size} ranks")
    per = n // mesh.size
    lo = mesh.rank * per
    return JPoint(*(a[lo:lo + per] for a in pts))


def all_gather_points(mesh: Mesh, ops, p: JPoint) -> JPoint:
    """Every rank's point batch, stacked: (size,) + p's shape, in one
    collective ([X | Y | Z] rows)."""
    batch = tuple(msmod._batch_shape(ops, p))
    packed = mesh.all_gather(msmod._pack(p, batch))
    return msmod._unpack(packed, tuple(p.x.shape[len(batch):]))


def msm_sharded(ops, mesh: Mesh, pts_local: JPoint,
                scalars_local: torch.Tensor, window_bits: int = 8,
                use_pippenger: bool = True, affine: bool = False) -> JPoint:
    """sum_i s_i P_i over the whole mesh, given this rank's stripe of the
    points and of the (N, 8) standard-form scalars (a stripe of any
    length: it runs as it is, unpadded).  use_pippenger=False runs the
    stripe as batched scalar multiplications and a tree sum (the small-N
    oracle).  affine=True asserts the batch_normalize invariant on the
    points (see ops.msm)."""
    if use_pippenger:
        part = msmod.msm_windowed(ops, pts_local, scalars_local,
                                  window_bits, affine)
    else:
        part = msmod.tree_sum(
            ops, msmod.batch_scalar_mul(ops, pts_local, scalars_local))
    return msmod.tree_sum(ops, all_gather_points(mesh, ops, part))
