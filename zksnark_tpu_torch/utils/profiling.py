"""Per-phase timing and work counters.

The port's counterpart of `zksnark_tpu/utils/profiling.py`: a phase
timer on the host clock, which ends a phase on a CUDA tensor with
`torch.cuda.synchronize`, and work counters for one MSM and one NTT, so
that a time can be turned into a rate (points/s, butterflies/s) or held
against a bound.

`limb_muls` counts the port's own unit: 32-bit multiply-adds, 264 per
Montgomery product (CIOS on 8 words: 8 rows of 2 x 16 half-products plus
one quotient digit, `chip_smoke.py`'s IMAD_PER_MUL).  The JAX package's
field of the same name counts 8-bit digit multiply-adds of its TPU
layout (3 x 32 x 32 per product); `point_adds`, `butterflies` and
`gexp_equiv` are the JAX package's values.
"""

from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

# 32-bit multiply-adds per Montgomery product and field products per
# mixed point add (the JAX package's count)
MULADDS_PER_MONT_MUL = 8 * (2 * 16 + 1)
MULS_PER_POINT_ADD = 16


@dataclass
class PhaseTimer:
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; `block_on`, a tensor (or a tuple or list of
        them), is waited for before the clock stops: a CUDA tensor by
        synchronizing its card."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait(block_on)
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def rate(self, counter: str, phase: str) -> Optional[float]:
        if phase not in self.phases or self.phases[phase] == 0:
            return None
        return self.counters.get(counter, 0.0) / self.phases[phase]

    def report(self) -> str:
        out = {"phases_s": {k: round(v, 4) for k, v in self.phases.items()},
               "counters": self.counters}
        return json.dumps(out, indent=2)


def _wait(obj) -> None:
    if isinstance(obj, (tuple, list)):
        for o in obj:
            _wait(o)
        return
    import torch

    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        torch.cuda.synchronize(obj.device)


def msm_work(n_points: int, window_bits: int) -> Dict[str, float]:
    """Approximate point adds and 32-bit multiply-adds of one MSM: per
    window ~1 mixed add per point (the chunked scan) and ~4 general adds
    per bucket."""
    n_windows = -(-256 // window_bits)
    point_adds = n_windows * (n_points + 4 * (1 << window_bits))
    return {"point_adds": point_adds,
            "limb_muls": point_adds * MULS_PER_POINT_ADD
            * MULADDS_PER_MONT_MUL,
            "gexp_equiv": n_points}


def ntt_work(n: int) -> Dict[str, float]:
    """Butterflies and 32-bit multiply-adds of one size-n transform (one
    Montgomery product per butterfly)."""
    butterflies = n // 2 * int(math.log2(n))
    return {"butterflies": butterflies,
            "limb_muls": butterflies * MULADDS_PER_MONT_MUL}
