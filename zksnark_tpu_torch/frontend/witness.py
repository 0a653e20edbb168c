"""Witness generation: evaluate a ``.zk`` program on concrete inputs.

The port's own copy of `zksnark_tpu/frontend/witness.py`.  The result is
``[1] ++ [value of each variable in canonical order]``, the canonical
order being `ast.variable_order` (first appearance at or after
``verify``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..field.host import PrimeField
from . import ast
from .ast import StructureErr


def evaluate(expr, assignments: Dict[str, int],
             field: PrimeField) -> Optional[int]:
    """Recursive interpreter; None when an unassigned variable is
    referenced (under-constrained)."""
    kind = expr[0]
    if kind == "lit":
        return expr[1]
    if kind == "var":
        return assignments.get(expr[1])
    if kind == "mul":
        left = evaluate(expr[1], assignments, field)
        if left is None:
            return None
        right = evaluate(expr[2], assignments, field)
        if right is None:
            return None
        return field.mul(left, right)
    if kind == "add":
        acc = field.zero()
        for term in expr[1]:
            val = evaluate(term, assignments, field)
            if val is None:
                return None
            acc = field.add(acc, val)
        return acc
    return None


def weights(code: str, values: Sequence[int], field: PrimeField) -> List[int]:
    """The witness of `code` on the `in` values `values`."""
    assignments: Dict[str, int] = {}
    exprs = ast.expressions(code, field)
    tokens = ast.try_to_list(code, field)
    variables = ast.variable_order(tokens)
    it = iter(exprs)

    first = next(it, None)
    if first is None or first[0] != "in":
        raise StructureErr(None, "Expected first expression to be 'in'")
    inputs = first[1]
    if len(inputs) != len(values):
        raise StructureErr(None, "Wrong number of values supplied")
    for e, val in zip(inputs, values):
        assignments[e[1]] = field.from_int(val)

    second = next(it, None)
    if second is None or second[0] != "out":
        raise StructureErr(None, "Expected second expression to be 'out'")

    third = next(it, None)
    if third is None or third[0] != "verify":
        raise StructureErr(None, "Expected third expression to be 'verify'")

    fourth = next(it, None)
    if fourth is None or fourth[0] != "program":
        raise StructureErr(None, "Expected fourth expression to be 'program'")

    for assignment in fourth[1]:
        if assignment[0] != "assign":
            raise StructureErr(
                None, "Program expression must be a list of '=' expressions")
        name = assignment[1][1]
        if name in assignments:
            raise StructureErr(
                None, "Attempted to assign to an already assigned variable")
        value = evaluate(assignment[2], assignments, field)
        if value is None:
            raise StructureErr(None, "Under constrained expression")
        assignments[name] = value

    try:
        ordered = [assignments[v] for v in variables]
    except KeyError:
        raise StructureErr(
            None, "Every variable should have an assignment") from None

    return [field.one()] + ordered
