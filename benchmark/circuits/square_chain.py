"""The square chain x^(2^N), one gate per squaring: a copy of the
generator `zksnark_tpu_torch/bench.py:synthetic_square_chain`, split into
the constraint system and the witness of a statement x.

Wires: [unity, x (verify), t_1 .. t_N], gate g: t_g = t_{g-1}^2 with t_0 = x.
"""

from __future__ import annotations

from zksnark_tpu_torch.field.host import FR
from zksnark_tpu_torch.frontend.r1cs import R1CS


def statement(cfg: dict, rng) -> int:
    return rng.randrange(1, FR.p)


class Circuit:
    def __init__(self, cfg: dict):
        self.n_gates = int(cfg["gates"])

    def r1cs(self) -> R1CS:
        num_wires = self.n_gates + 2
        u = [[] for _ in range(num_wires)]
        v = [[] for _ in range(num_wires)]
        w = [[] for _ in range(num_wires)]
        for g in range(1, self.n_gates + 1):
            src = 1 if g == 1 else g  # wire feeding gate g
            dst = g + 1
            u[src].append((g, 1))
            v[src].append((g, 1))
            w[dst].append((g, 1))
        return R1CS(u=u, v=v, w=w, roots=list(range(1, self.n_gates + 1)),
                    input=1)

    def witness(self, x: int) -> list:
        wit = [1, x]
        cur = x
        for _ in range(self.n_gates):
            cur = cur * cur % FR.p
            wit.append(cur)
        return wit
