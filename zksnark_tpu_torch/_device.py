"""Where the port's entry points put their tensors.

Every entry point takes ``device=None``: None means the first CUDA card,
and a host without one raises instead of quietly running the plain
PyTorch versions of the kernels on the CPU.  Tests ask for the CPU by
passing ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "zksnark_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return torch.device("cuda")
