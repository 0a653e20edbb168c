"""The square chain, from its definition: t_0 = x, t_g = t_{g-1}^2 for g =
1 .. N, one gate each; x is the only public wire.  Gate g (domain index
g - 1) has t_{g-1} as its left and right combination and t_g as its
output."""

from __future__ import annotations

from .groth16 import R, Lagrange, Sums


class Reference:
    def __init__(self, cfg: dict):
        self.n_gates = int(cfg["gates"])
        self.public = 1
        self.num_wires = self.n_gates + 2
        self.nnz = 3 * self.n_gates          # one u, v and w entry a gate

    def sums(self, x: int, lag: Lagrange):
        """(Sums, the number of the reference's own checks that fail)."""
        chain = [x % R]
        for _ in range(self.n_gates):
            chain.append(chain[-1] * chain[-1] % R)
        u = lag.dot(chain[:-1])
        w = lag.dot(chain[1:])
        pub = lag.at(0) * chain[0] % R
        return Sums(u, u, w, pub, pub, 0), 0
