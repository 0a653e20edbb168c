"""K1: batched Montgomery multiplication — the CUDA kernel
(`csrc/montmul.cu`), its plain PyTorch version, and the launch counts.

Counterpart of `zksnark_tpu/ops/montmul.py` (`mont_mul_pallas`,
`mont_mul_auto`, `from_mont_auto`).  `mont_mul` broadcasts its operands,
flattens them to (N, 8) and launches one thread per product on a CUDA
tensor; on a CPU tensor it runs the plain version (`field.limb.mont_mul`).
"""

from __future__ import annotations

import torch

from .. import _build
from ..field import limb
from ..field.limb import FR_CTX, MontCtx

L = limb.L

# launches of the kernel, by field; reset and read by chip_smoke.py
LAUNCHES = {"montmul_fr": 0, "montmul_fq": 0}


def kernel_name(ctx: MontCtx) -> str:
    return "montmul_fr" if ctx.p == FR_CTX.p else "montmul_fq"


def mont_mul_plain(ctx: MontCtx, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    return limb.mont_mul(ctx, a, b)


def _flat(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != limb.DT or t.shape[-1] != L:
        raise ValueError(f"montmul kernel needs (..., {L}) int32 limbs, "
                         f"got {tuple(t.shape)} {t.dtype}")
    t = t.reshape(-1, L).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def mont_mul_cuda(ctx: MontCtx, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    fa, fb = _flat(a), _flat(b)
    out = torch.empty_like(fa)
    n = fa.shape[0]
    if n:
        code = _build.lib("montmul.cu").zk_montmul(
            fa.data_ptr(), fb.data_ptr(), out.data_ptr(), n,
            0 if ctx.p == FR_CTX.p else 1,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(code, "montmul")
        LAUNCHES[kernel_name(ctx)] += 1
    return out.reshape(shape)


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p, broadcasting; the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if a.device.type == "cuda":
        return mont_mul_cuda(ctx, a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    raise ValueError(f"mont_mul: unsupported device {a.device}")


def from_mont(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form (a product with the plain 1)."""
    return mont_mul(ctx, a, ctx.const("std_one", a.device))
