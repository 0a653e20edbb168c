"""Sparse constraint system: the interchange format between frontends and
the prover.

The port's own copy of the `R1CS` dataclass of `zksnark_tpu/frontend/
r1cs.py`: per-wire sparse rows of (root, value) points for u/v/w, the list
of gate roots, and the number of verify (public-input) wires.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Tuple

Points = List[Tuple[int, int]]  # sparse (root, value) pairs for one wire


@dataclass
class R1CS:
    u: List[Points] = dc_field(default_factory=list)
    v: List[Points] = dc_field(default_factory=list)
    w: List[Points] = dc_field(default_factory=list)
    roots: List[int] = dc_field(default_factory=list)
    input: int = 0  # number of verify wires (unity wire NOT counted)

    @property
    def num_wires(self) -> int:
        return len(self.u)

    @property
    def num_gates(self) -> int:
        return len(self.roots)
