"""Sparse constraint system: the interchange format between frontends and
the prover.

The port's own copy of the `R1CS` dataclass of `zksnark_tpu/frontend/
r1cs.py`: per-wire sparse rows of (root, value) points for u/v/w, the list
of gate roots, and the number of verify (public-input) wires; equality
field by field (the dataclass's), the host check that a witness
satisfies every gate, and the array exports: dense (wires x gates)
matrices and COO triples.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Tuple

import numpy as np

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

    def dense_point_matrices(self):
        """(U, V, W) as object-dtype numpy matrices of shape (num_wires,
        num_gates): entry [i, j] is the value wire i contributes at root
        j (python ints, exact in any field).  The roots must be exactly
        the gate roots, as every frontend makes them."""
        root_index = {r: j for j, r in enumerate(self.roots)}
        shape = (self.num_wires, self.num_gates)
        out = []
        for rows in (self.u, self.v, self.w):
            m = np.zeros(shape, dtype=object)
            for i, points in enumerate(rows):
                for (root, val) in points:
                    m[i, root_index[root]] += val
            out.append(m)
        return tuple(out)

    def coo(self):
        """For each of u, v, w: (wire indices int32, gate indices int32,
        values as a list of python ints, which may exceed int64)."""
        root_index = {r: j for j, r in enumerate(self.roots)}
        out = []
        for rows in (self.u, self.v, self.w):
            wires, gates, vals = [], [], []
            for i, points in enumerate(rows):
                for (root, val) in points:
                    wires.append(i)
                    gates.append(root_index[root])
                    vals.append(val)
            out.append((np.asarray(wires, dtype=np.int32),
                        np.asarray(gates, dtype=np.int32), vals))
        return tuple(out)

    def check_satisfied(self, weights, p: int):
        """The gate roots whose constraint the witness violates ([] when
        it satisfies them all).  Weights shorter than num_wires are
        zero-extended, as the prover extends them."""
        w_full = list(weights) + [0] * (self.num_wires - len(weights))
        sums = []
        for rows in (self.u, self.v, self.w):
            acc = {root: 0 for root in self.roots}
            for i, points in enumerate(rows):
                for (r, val) in points:
                    acc[r] = (acc[r] + val * w_full[i]) % p
            sums.append(acc)
        us, vs, ws = sums
        return [r for r in self.roots if us[r] * vs[r] % p != ws[r]]
