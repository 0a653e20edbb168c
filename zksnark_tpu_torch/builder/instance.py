"""CircuitInstance: bind a built Circuit to verify/input wires and emit R1CS.

The port's own copy of `zksnark_tpu/builder/instance.py`.  The R1CS rows
are aligned to the ordered wires, so they line up with the weight vector.

Wire order: [unity] ++ verify wires (declaration order) ++ remaining wires
(ascending id).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from ..frontend.r1cs import R1CS
from .circuit import C_TERM, Circuit, LEFT, OUTPUT, RIGHT, UNITY_WIRE


class CircuitInstance:
    def __init__(self, circuit: Circuit, verification_wires: Sequence[int],
                 input_wires: Sequence[int],
                 sub_circuit_point: Callable[[int], int]):
        self.circuit = circuit
        self.verification_wires = list(verification_wires)
        self.input_wires = list(input_wires)
        self.sub_circuit_point = sub_circuit_point

        verify_set = set(self.verification_wires)
        used = sorted(circuit.wire_assignments.keys())
        used_set = set(used)
        ordered = [UNITY_WIRE]
        ordered += [w for w in self.verification_wires if w in used_set]
        ordered += [w for w in used
                    if w != UNITY_WIRE and w not in verify_set]
        self.ordered_wires = ordered

    def weights(self, inputs: Sequence[int]) -> List[int]:
        """From a reset circuit: assign the inputs, set the gates' and
        hints' wires in build order (`Circuit.run`), then read every
        ordered wire (`evaluate` reports one left unset)."""
        if len(inputs) != len(self.input_wires):
            raise ValueError(
                "must have the same number of input wires and assignments")
        c = self.circuit
        c.reset()
        for wire, value in zip(self.input_wires, inputs):
            c.set_value(wire, value)
        c.run()
        vals = c.wire_values
        return [vals[w] if vals[w] is not None else c.evaluate(w)
                for w in self.ordered_wires]

    def r1cs(self) -> R1CS:
        """Emit the constraint system with rows aligned to
        ordered_wires; gate `sc` sits at root `sub_circuit_point(sc)`."""
        point = self.sub_circuit_point
        u: List[List] = []
        v: List[List] = []
        w: List[List] = []
        for wire in self.ordered_wires:
            ui, vi, wi = [], [], []
            for (kind, weight, sc_id) in self.circuit.wire_assignments.get(
                    wire, ()):
                root = point(sc_id)
                if kind == LEFT:
                    ui.append((root, weight))
                elif kind == RIGHT:
                    vi.append((root, weight))
                elif kind == OUTPUT:
                    wi.append((root, self.circuit.field.one()))
                elif kind == C_TERM:
                    wi.append((root, weight))
            u.append(ui)
            v.append(vi)
            w.append(wi)

        roots = [point(sc) for sc in range(self.circuit.num_sub_circuits())]
        return R1CS(u=u, v=v, w=w, roots=roots,
                    input=len(self.verification_wires))
