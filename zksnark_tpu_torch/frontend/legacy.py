"""Parser for the legacy line-oriented circuit format.

The port's own copy of `zksnark_tpu/frontend/legacy.py`, the format of
``quad_share.zk`` / ``cubic_share.zk``:

    line 1: input (verify) variable names
    line 2: witness variable names
    line 3: temp variable names
    line 4: blank
    then one gate per line:  out ( left... ) ( right... )

Left-side symbol ``1`` means the unity wire; every other symbol (and every
right-side symbol) is looked up in the concatenated variable list, 1-based.
"""

from __future__ import annotations

from ..field.host import PrimeField
from .r1cs import R1CS


def parse(code: str, field: PrimeField) -> R1CS:
    lines = code.splitlines()
    inputs = lines[0].split(" ")
    witness = lines[1].split(" ")
    temp_vars = lines[2].split(" ")
    gate_lines = lines[4:]

    all_vars = inputs + witness + temp_vars
    num_vars = len(all_vars) + 1

    def pos(sym: str) -> int:
        return all_vars.index(sym) + 1

    u = [[] for _ in range(num_vars)]
    v = [[] for _ in range(num_vars)]
    w = [[] for _ in range(num_vars)]

    for n, line in enumerate(gate_lines):
        symbols = iter(line.split(" "))
        first = next(symbols)
        root = field.from_int(n + 1)
        w[pos(first)].append((root, field.one()))
        next(symbols)  # "("

        for sym in symbols:
            if sym == ")":
                break
            if sym == "1":
                u[0].append((root, field.one()))
            else:
                u[pos(sym)].append((root, field.one()))
        next(symbols)  # "("

        for sym in symbols:
            if sym == ")":
                break
            v[pos(sym)].append((root, field.one()))

    roots = [field.from_int(r) for r in range(1, len(gate_lines) + 1)]
    return R1CS(u=u, v=v, w=w, roots=roots, input=len(inputs))
