"""Quadratic Arithmetic Program construction (host tier).

The port's own copy of `zksnark_tpu/groth16/qap.py`: every sparse
per-wire (root, value) row of the R1CS is interpolated over the gate
roots into a dense polynomial (Lagrange, exact over any roots), and ``t``
is the vanishing polynomial of the roots.  The device prover
(`groth16/prover.py`) instead keeps the rows in evaluation form on a
radix-2 domain and interpolates with the iNTT.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field.host import PrimeField
from ..frontend.r1cs import R1CS
from ..poly import dense


@dataclass
class QAP:
    u: List[dense.Poly]
    v: List[dense.Poly]
    w: List[dense.Poly]
    t: dense.Poly
    input: int
    degree: int
    field: PrimeField

    @property
    def num_wires(self) -> int:
        return len(self.u)


def from_r1cs(field: PrimeField, r1cs: R1CS) -> QAP:
    roots = r1cs.roots
    u = [dense.interpolate(field, roots, pts) for pts in r1cs.u]
    v = [dense.interpolate(field, roots, pts) for pts in r1cs.v]
    w = [dense.interpolate(field, roots, pts) for pts in r1cs.w]
    assert len(u) == len(v) == len(w)
    t = dense.root_poly(field, roots)
    return QAP(u=u, v=v, w=w, t=t, input=r1cs.input,
               degree=dense.degree(t), field=field)
