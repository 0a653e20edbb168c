"""The multi-process runtime of the mesh path, over `torch.distributed`.

Counterpart of `zksnark_tpu/parallel/multihost.py`.  The JAX package's
mesh is single-controller: one process owns every device and a
`shard_map` takes and returns global arrays.  Here every rank is a
process that runs the same program on its own stripe (SPMD), and a
`Mesh` names the process group, this rank and its device.  Each
function of `parallel/` says what a rank holds going in and coming out.

Nothing here runs at import time: importing the package starts no
process group.

- `init_distributed(...)` joins the group (idempotent).  Arguments left
  out come from torch's own environment variables (`MASTER_ADDR`,
  `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`), as `torchrun`
  sets them.  The backend is `nccl` for a CUDA device and `gloo` for the
  CPU or when asked.
- `global_mesh()` is the `Mesh` over the whole world.
- `host_local_slice(n)` is this rank's equal contiguous stripe of n.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device

_DEVICE: Optional[torch.device] = None


@dataclass(frozen=True)
class Mesh:
    """A process group, this process's rank in it, its size and the
    device this rank computes on, with the two collectives of the mesh
    path.  A gloo group moves CUDA tensors through host memory (gloo's
    collectives here take host tensors): the kernels still run on the
    card, only the exchange is staged."""

    group: object          # a torch.distributed group; None: the world
    rank: int
    size: int
    device: torch.device
    backend: str

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type != "cpu":
            t = t.cpu()
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size,) + t.shape on every rank: row r is rank r's t."""
        src = self._send(t).reshape(-1)
        out = src.new_empty((self.size * src.numel(),))
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.reshape((self.size,) + tuple(t.shape)).to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t of shape (size, ...): row j goes to rank j; returns the same
        shape, row j received from rank j."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all needs {self.size} rows, got "
                             f"{tuple(t.shape)}")
        src = self._send(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(t.device)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> None:
    """Join the process group (idempotent).

    device: this rank's device; None is the card `LOCAL_RANK` names
    (`cuda:0` without it), and "cpu" runs the plain versions.  backend:
    None is `nccl` on a CUDA device and `gloo` on the CPU; "gloo" with a
    CUDA device keeps the kernels on the card and stages the exchange
    through host memory (several ranks may then share one card, which
    NCCL refuses)."""
    global _DEVICE
    if dist.is_initialized():
        return
    if device is None:
        resolve_device(None)          # raises without a card
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _DEVICE = dev


def local_device() -> torch.device:
    """The device `init_distributed` chose for this rank."""
    if _DEVICE is None:
        raise RuntimeError("init_distributed has not run in this process")
    return _DEVICE


def mesh_of(group, ranks: int) -> Mesh:
    return Mesh(group=group, rank=dist.get_rank(group), size=ranks,
                device=local_device(), backend=dist.get_backend(group))


def global_mesh() -> Mesh:
    """The mesh over every rank of the world."""
    return mesh_of(None, dist.get_world_size())


def host_local_slice(n: int) -> slice:
    """This rank's [lo, hi) stripe of a length-n leading axis (equal
    contiguous stripes, in rank order)."""
    per = n // dist.get_world_size()
    i = dist.get_rank()
    return slice(i * per, (i + 1) * per)
