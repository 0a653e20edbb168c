"""Lexer and recursive-descent parser for the lisp-esque ``.zk`` circuit DSL.

The port's own copy of `zksnark_tpu/frontend/ast.py`: whitespace
tokenization with "sticky" parentheses (``(in`` / ``x)`` hold no interior
whitespace), paren-depth grouping, the Expression tree, and the canonical
variable order (first appearance at or after the ``verify`` keyword).
The error classes and messages are the JAX package's, word for word.

Tokens:      ("open",) ("close",) ("kw", k) ("var", name) ("lit", value)
Expressions: ("in"|"out"|"verify", [("var", n), ...])
             ("program", [gates]) ("assign", lhs, rhs) ("mul", l, r)
             ("add", [exps]) ("var", name) ("lit", value)
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ..field.host import PrimeField

Token = Tuple
Expression = Tuple

KEYWORDS = {"in": "in", "out": "out", "verify": "verify",
            "program": "program", "=": "assign", "*": "mul", "+": "add"}


class ParseErr(Exception):
    """Base of the two error kinds."""


class SyntaxErr(ParseErr):
    def __init__(self, line: int, msg: str):
        super().__init__(f"line {line}: {msg}")
        self.line = line
        self.msg = msg


class StructureErr(ParseErr):
    def __init__(self, gate: Optional[int], msg: str):
        super().__init__(msg if gate is None else f"gate {gate}: {msg}")
        self.gate = gate
        self.msg = msg


def _split_at_char(s: str, c: str) -> Tuple[str, str]:
    """Split before the first occurrence of c."""
    i = s.find(c)
    return (s, "") if i < 0 else (s[:i], s[i:])


def parse_token(substr: str, field: PrimeField) -> List[Token]:
    """Tokenize one whitespace-delimited substring.

    Valid shapes: ``({keyword}``, ``{var}``, ``{var})...``, ``{literal})...``.
    Raises ValueError on invalid input.
    """
    tokens: List[Token] = []

    if substr.startswith("("):
        tokens.append(("open",))
        substr = substr[1:]

    if len(substr) == 0:
        raise ValueError("found whitespace after '('")

    if substr in KEYWORDS:
        tokens.append(("kw", substr))
        return tokens

    if "(" in substr:
        raise ValueError("unexpected '('")
    if "*" in substr or "+" in substr or "=" in substr:
        raise ValueError("unexpected operator")

    start, end = _split_at_char(substr, ")")
    if tokens and end:
        raise ValueError("unexpected ')'")
    if not start:
        # a bare ")" (or "()")
        raise ValueError("unexpected ')'")

    if start[0].isdigit():
        lit = field.parse(start)
        if lit is None:
            raise ValueError("could not parse literal")
        tokens.append(("lit", lit))
    else:
        tokens.append(("var", start))

    for c in end:
        if c != ")":
            raise ValueError("expected ')'")
        tokens.append(("close",))

    return tokens


def try_to_list(code: str, field: PrimeField) -> List[Token]:
    """Tokenize a whole program; errors carry 1-based line numbers."""
    tokens: List[Token] = []
    for line_no, line in enumerate(code.splitlines(), start=1):
        for substr in line.split():
            try:
                tokens.extend(parse_token(substr, field))
            except ValueError as e:
                raise SyntaxErr(line_no, str(e)) from None
    return tokens


def variable_order(tokens: List[Token]) -> List[str]:
    """Canonical wire order: first appearance of each variable at or after
    the ``verify`` keyword."""
    seen = set()
    order: List[str] = []
    started = False
    for t in tokens:
        if not started:
            started = t == ("kw", "verify")
            if not started:
                continue
        if t[0] == "var" and t[1] not in seen:
            seen.add(t[1])
            order.append(t[1])
    return order


def next_group(it: Iterator[Token]) -> List[Token]:
    """Pull the next balanced group, outer parens stripped."""
    first = next(it, None)
    if first is None:
        return []
    if first == ("open",):
        depth = 1
        group: List[Token] = []
        for t in it:
            if t == ("open",):
                depth += 1
            elif t == ("close",):
                depth -= 1
                if depth == 0:
                    break
            group.append(t)
        return group
    if first[0] in ("var", "lit"):
        return [first]
    raise StructureErr(None, "Cannot parse malformed group")


def parse_expression(tokens: List[Token]) -> Expression:
    """Parse one outer-paren-stripped group."""
    it = iter(tokens)
    first = next(it, None)
    if first is None:
        raise StructureErr(None, "Malformed expression")

    if first[0] in ("var", "lit"):
        return first
    if first[0] != "kw":
        raise StructureErr(None, "Malformed expression")

    k = first[1]
    if k in ("in", "out", "verify"):
        exprs = []
        for t in it:
            if t[0] != "var":
                raise StructureErr(
                    None, f"Non variable found in '{k}' expression")
            exprs.append(t)
        return (k, exprs)
    if k == "program":
        gates = []
        while True:
            group = next_group(it)
            if not group:
                break
            gates.append(parse_expression(group))
        return ("program", gates)
    if k == "=":
        left = next_group(it)
        if len(left) != 1 or left[0][0] != "var":
            raise StructureErr(None, "Can only assign to a variable")
        right = parse_expression(next_group(it))
        return ("assign", left[0], right)
    if k == "*":
        left = parse_expression(next_group(it))
        right = parse_expression(next_group(it))
        return ("mul", left, right)
    if k == "+":
        exprs = []
        while True:
            group = next_group(it)
            if not group:
                break
            exprs.append(parse_expression(group))
        return ("add", exprs)
    raise StructureErr(None, "Malformed expression")


def expressions(code: str, field: PrimeField) -> List[Expression]:
    """Tokenize and parse all top-level groups."""
    tokens = try_to_list(code, field)
    it = iter(tokens)
    out = []
    while True:
        group = next_group(it)
        if not group:
            break
        out.append(parse_expression(group))
    return out
