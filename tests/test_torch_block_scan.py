"""The MSM tail's block scan (`block_scan` in `zksnark_tpu_torch.ops.
curve_kernels`, the chunk carries' `msm._prefix_scan` and `msm.tree_sum`
over it) against a sequential running sum on the host curve, on G1 and G2.

On CPU tensors the wrapper runs its plain version, which runs the
kernel's adds in the kernel's association (the card's check holds the
kernel to it bit for bit).  Its sums are other Jacobian representatives
than a chain's, so the check here is group equality: every inclusive
prefix within a block (collecting) and every block total (collecting or
not), in affine form, equal the host's running sums of the same points.

One block shape, 4 threads x 2 steps (8 positions a block), at n = 1, 2,
7, 8, 9 positions in 3 columns; and the chooser's shape at a size whose
scan takes two levels, through `_prefix_scan` (the block carries' fix-up)
and `tree_sum`.  Column 0 holds, in every block, a step equal to the
accumulator (its thread's walk doubles), a step equal to the negation of
the accumulator (it cancels), a step at infinity, and two neighbouring
threads with equal sums (the first round doubles); column 1 is all
infinity (a window whose buckets are all empty); column 2 repeats one
block, so its block totals are equal (the next level doubles).  Points
are real multiples of the generator with Z rescaled at random.
Tolerance: exact equality.
"""

import random

import pytest
import torch

from zksnark_tpu_torch.curve import bn254 as hc
from zksnark_tpu_torch.curve import jacobian as jac
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
from zksnark_tpu_torch.ops import curve_kernels as ck
from zksnark_tpu_torch.ops import msm

torch.set_num_threads(1)     # small tensors: threads only add overhead

GROUPS = {"g1": (FQ_OPS, hc.G1_GEN_PT, hc.g1_add, hc.g1_neg),
          "g2": (FQ2_OPS, hc.G2_GEN, hc.g2_add, hc.g2_neg)}
THREADS, STEPS = 4, 2
SPAN = THREADS * STEPS
COLS = 3


class Group:
    """Host points k G (from a table of 2^i G) and their port batches."""

    def __init__(self, name):
        self.name = name
        self.ops, gen, self.add, self.neg = GROUPS[name]
        self.rng = random.Random(18 if name == "g1" else 19)
        self.pow2 = [gen]
        for _ in range(40):
            self.pow2.append(self.add(self.pow2[-1], self.pow2[-1]))

    def mul(self, k):
        acc = None
        for i in range(k.bit_length()):
            if k >> i & 1:
                acc = self.add(acc, self.pow2[i])
        return acc

    def point(self):
        return self.mul(self.rng.randrange(1, 1 << 40))

    def batch(self, host, shape):
        """Host points (None: infinity) as a port batch of `shape`, each
        finite point's Z rescaled by a random lambda."""
        ops, g1 = self.ops, self.name == "g1"
        zero = 0 if g1 else [0, 0]

        def coord(h, k):
            return zero if h is None else (h[k] if g1 else list(h[k]))

        def mont(vals):
            return torch.from_numpy(ops.to_mont_np(vals))

        lam = mont([self.rng.randrange(1, 1 << 60) if g1 else
                    [self.rng.randrange(1, 1 << 60), self.rng.randrange(
                        1 << 60)] for _ in host])
        inf = torch.tensor([h is None for h in host])
        l2 = ops.mul(lam, lam)
        z = ops.select(inf, ops.zero((len(host),)), lam)
        p = jac.JPoint(ops.mul(mont([coord(h, 0) for h in host]), l2),
                       ops.mul(mont([coord(h, 1) for h in host]),
                               ops.mul(l2, lam)), z)
        elem = p.x.shape[1:]
        return jac.JPoint(*(a.reshape(shape + elem) for a in p))

    def affine(self, p):
        """A port batch in affine form, host points (None: infinity), row
        by row over its flattened batch."""
        flat = jac.JPoint(*(a.reshape((-1,) + a.shape[a.dim()
                                                       - self.ops.elem_ndim:])
                            for a in p))
        aff = jac.to_affine_np(self.ops, flat)
        if self.name == "g1":
            return list(aff)
        return [None if a is None else tuple(map(tuple, a)) for a in aff]


@pytest.fixture(scope="module", params=["g1", "g2"])
def group(request):
    return Group(request.param)


def _columns(g, n, span):
    """n positions x COLS columns of host points (see the module's
    docstring), blocks of `span` positions."""
    col0, col2 = [], []
    base = [g.point() for _ in range(span)]
    for i in range(n):
        j = i % span
        if j % 8 == 1:                 # a step equal to the accumulator
            col0.append(col0[-1])
        elif j % 8 == 3:               # the accumulator's negation
            col0.append(g.neg(col0[-1]))
        elif j % 8 in (4, 6):          # infinity; threads 2, 3 sum equal
            col0.append(None)
        elif j % 8 == 7:
            col0.append(col0[-2])
        else:
            col0.append(g.point())
        col2.append(base[j])
    return [[c0, None, c2] for c0, c2 in zip(col0, col2)]


def _running(g, host, start):
    """Inclusive running sums down each column, restarting at the
    positions in `start`."""
    out, acc = [], [None] * COLS
    for i, row in enumerate(host):
        if i in start:
            acc = [None] * COLS
        acc = [g.add(a, p) for a, p in zip(acc, row)]
        out.append(acc)
    return out


@pytest.mark.parametrize("collect", [True, False], ids=["collect", "total"])
@pytest.mark.parametrize("n", [1, 2, SPAN - 1, SPAN, SPAN + 1, "levels"])
def test_block_scan_equals_running_sum(group, n, collect):
    g = group
    if n == "levels":
        # the chooser's block at s = 1 (64 positions), three blocks a
        # column: `_prefix_scan` scans the block totals and adds each
        # block's carry, `tree_sum` takes a second level
        span = ck.BLOCK_SCAN_BLOCK
        n = 2 * span + 5
        assert ck.block_scan_shape(n, COLS) == (span, 1)
        host = _columns(g, n, span)
        pts = g.batch([p for row in host for p in row], (n, COLS))
        before = dict(ck.LAUNCHES)
        if collect:
            got = msm._prefix_scan(g.ops, pts)
            want = _running(g, host, {0})
        else:
            got = msm.tree_sum(g.ops, pts)
            want = _running(g, host, {0})[-1:]
        assert ck.LAUNCHES == before   # CPU tensors run the plain version
        assert g.affine(got) == [p for row in want for p in row]
        return
    host = _columns(g, n, SPAN)
    pts = g.batch([p for row in host for p in row], (n, COLS))
    before = dict(ck.LAUNCHES)
    totals, within = ck.block_scan(g.ops, pts, collect, THREADS, STEPS)
    assert ck.LAUNCHES == before
    blocks = -(-n // SPAN)
    assert totals.z.shape[:2] == (blocks, COLS)
    want = _running(g, host, set(range(0, n, SPAN)))
    ends = [want[min(n, k + SPAN) - 1] for k in range(0, n, SPAN)]
    assert g.affine(totals) == [p for row in ends for p in row]
    if collect:
        assert within.z.shape[:2] == (n, COLS)
        assert g.affine(within) == [p for row in want for p in row]
    else:
        assert within is None


def test_block_scan_shape_fills_the_card():
    """The tail's levels at 2^20 and 2^18 points (c = 16, chunks of 64:
    carries over 2^14 and 2^12 rows, the tree sum over 2^16 buckets, 16
    windows): the large levels hold 2^15 threads, in blocks of 64, and
    leave at most 64 block totals a window, which one block of the next
    level scans: two levels a scan."""
    for ops in (FQ_OPS, FQ2_OPS):
        # the prove's MSMs run 2^20 + 3 and 2^20 + 2 points unpadded: one
        # chunk row more than 2^14 keeps the shape of 2^14
        for n in (1 << 14, (1 << 14) + 1, 1 << 12, (1 << 12) + 1, 1 << 16):
            threads, steps = ck.block_scan_shape(n, 16)
            blocks = -(-n // (threads * steps))
            assert threads == ck.BLOCK_SCAN_BLOCK == 64
            assert steps == min(32, n >> 11) <= ck.BLOCK_SCAN_STEPS
            assert blocks * threads * 16 >= ck.BLOCK_SCAN_LANES == 1 << 15
            t2, s2 = ck.block_scan_shape(blocks, 16)
            assert t2 >= blocks and s2 == 1
    with pytest.raises(ValueError, match="power of two"):
        ck.block_scan(FQ_OPS, jac.infinity(FQ_OPS, (4,)), True, 3, 1)
    with pytest.raises(ValueError, match="power of two"):
        ck.block_scan(FQ2_OPS, jac.infinity(FQ2_OPS, (4,)), True, 128, 1)
