"""Compile a parsed ``.zk`` program into an `R1CS` constraint system.

The port's own copy of `zksnark_tpu/frontend/compiler.py`:

- the program's shape is exactly ``(in)(out)(verify)(program)``;
- one multiplication gate per ``(= var (* L R))``; gate roots are 1..=n;
- wire 0 is the constant unity wire, where literals accumulate;
- verify wires get indices 1..=input in declaration order; every other
  variable gets the next free index at first appearance;
- a verify variable may be (once) the output of a gate; any other
  already-seen variable may not.

An assignment whose right-hand side is *not* a ``(* ...)`` expression is
silently ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

from ..field.host import PrimeField
from . import ast
from .ast import StructureErr
from .r1cs import R1CS


def _linear_side(expr, side: List, other1: List, other2: List,
                 variables: Dict[str, int], gate: int, field: PrimeField,
                 u_first: bool) -> None:
    """One input (left or right) of a multiplication gate.  `side` holds
    this side's matrix rows, `other1` / `other2` the other two: a new wire
    appends a row to all three, in the order u, v, w."""
    kind = expr[0]
    if kind == "lit":
        side[0].append((gate, expr[1]))
    elif kind == "var":
        _touch_ordered(side, other1, other2, variables, expr[1], gate,
                       field.one(), u_first)
    elif kind == "add":
        for term in expr[1]:
            tkind = term[0]
            if tkind == "lit":
                side[0].append((gate, term[1]))
            elif tkind == "var":
                _touch_ordered(side, other1, other2, variables, term[1], gate,
                               field.one(), u_first)
            elif tkind == "mul":
                lhs, rhs = term[1], term[2]
                if lhs[0] != "lit":
                    raise StructureErr(
                        gate, "LHS of a '*' expression in a '+' expression "
                              "must be a literal")
                if rhs[0] != "var":
                    raise StructureErr(
                        gate, "RHS of a '*' expression in a '+' expression "
                              "must be a variable")
                _touch_ordered(side, other1, other2, variables, rhs[1], gate,
                               lhs[1], u_first)
            else:
                raise StructureErr(
                    gate, "Invalid expression found in '+' expression")
    else:
        raise StructureErr(gate, "Invalid expression found in '*' expression")


def _touch_ordered(side, other1, other2, variables, name, gate, coeff,
                   u_first: bool) -> None:
    """Add `coeff` at `gate` to the wire `name`, creating its rows (u, v,
    w kept aligned) at first appearance."""
    if name not in variables:
        variables[name] = len(side)
        if u_first:
            side.append([(gate, coeff)])     # u row
            other1.append([])                # v row
            other2.append([])                # w row
        else:
            other1.append([])                # u row
            side.append([(gate, coeff)])     # v row
            other2.append([])                # w row
    else:
        side[variables[name]].append((gate, coeff))


def parse(code: str, field: PrimeField) -> R1CS:
    """Compile ``.zk`` source; raises `ast.ParseErr`."""
    exprs = ast.expressions(code, field)

    variables: Dict[str, int] = {}
    gate = 0
    u: List[List] = [[]]
    v: List[List] = [[]]
    w: List[List] = [[]]
    n_input = 0

    if len(exprs) != 4:
        raise StructureErr(
            gate, "Expected exactly one each of 'in', 'out', 'verify' and "
                  "'program'")

    if exprs[0][0] != "in":
        raise StructureErr(gate, "Expected first expression to be 'in'")
    if exprs[1][0] != "out":
        raise StructureErr(gate, "Expected second expression to be 'out'")
    if exprs[2][0] != "verify":
        raise StructureErr(gate, "Expected third expression to be 'verify'")
    for var in exprs[2][1]:
        variables[var[1]] = len(u)
        u.append([])
        v.append([])
        w.append([])
        n_input += 1
    if exprs[3][0] != "program":
        raise StructureErr(gate, "Expected fourth expression to be 'program'")

    for assignment in exprs[3][1]:
        gate += 1
        if assignment[0] != "assign":
            raise StructureErr(
                gate, "Program expression must be a list of '=' expressions")
        lhs, rhs = assignment[1], assignment[2]
        name = lhs[1]

        # the gate's output wire
        if name not in variables:
            variables[name] = len(u)
            u.append([])
            v.append([])
            w.append([(gate, field.one())])
        elif variables[name] <= n_input:
            idx = variables[name]
            if w[idx]:
                raise StructureErr(
                    gate, "Varify variable cannot be the output of two "
                          "different gates")
            w[idx].append((gate, field.one()))
        else:
            raise StructureErr(
                gate, "Already declared variable cannot be the output wire "
                      "of a gate")

        # the gate's inputs (skipped when the RHS is not a mul)
        if rhs[0] == "mul":
            _linear_side(rhs[1], u, v, w, variables, gate, field, u_first=True)
            _linear_side(rhs[2], v, u, w, variables, gate, field, u_first=False)

    roots = [field.from_int(r) for r in range(1, gate + 1)]
    return R1CS(u=u, v=v, w=w, roots=roots, input=n_input)
