"""The frozen work counts against brute force at small sizes."""

import random

import numpy as np
import pytest

from benchmark import peaks, work

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def limbs(vals):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32).view(np.int32)


def brute_msm(group, vals):
    """The count's definition, scalar by scalar, every width tried."""
    best = None
    for c in work.WIDTHS:
        windows = -(-work.HALF_BITS // c)
        digits, used = 0.0, set()
        for s in vals:
            if s >= 1 << work.HALF_BITS:
                digits += 2 * windows * (1 - 2.0 ** -c)
                used.update(range(windows))
            else:
                for j in range(windows):
                    if (s >> (j * c)) & ((1 << c) - 1):
                        digits += 1
                        used.add(j)
        cost = (digits + len(used) * 2 ** c) * work.ADD[group]
        if len(used) > 1:
            cost += (len(used) - 1) * (c * work.DOUBLE[group]
                                       + work.ADD[group])
        if best is None or cost < best[0]:
            best = (cost, c)
    return best


@pytest.mark.parametrize("kind", ["bits", "small", "mixed", "full", "zero"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_count_matches_brute_force(kind, group):
    rng = random.Random(kind + group)
    n = 300
    vals = {
        "bits": lambda: rng.randrange(2),
        "small": lambda: rng.randrange(1 << rng.randrange(1, 127)),
        "mixed": lambda: rng.choice([0, 1, rng.randrange(1 << 64),
                                     rng.randrange(R)]),
        "full": lambda: rng.randrange(1 << 127, R),
        "zero": lambda: 0,
    }[kind]
    scalars = [vals() for _ in range(n)]
    got = work.msm_products(group, limbs(scalars))
    want = brute_msm(group, scalars)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


def test_msm_count_of_a_bit_witness():
    scalars = [1] * 100 + [0] * 28
    # width 1: one add a one, and one window's two reduction adds
    assert work.msm_products("g1", limbs(scalars)) == (6 * 102, 1)


def brute_butterflies(n):
    """Products of a radix-2 transform of size n, counted as it runs."""
    count = 0
    a = list(range(n))
    half = 1
    while half < n:
        for start in range(0, n, 2 * half):
            for j in range(half):
                count += 1                      # the twiddle product
                u, v = a[start + j], a[start + j + half]
                a[start + j], a[start + j + half] = u + v, u - v
        half *= 2
    return count


@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 8])
def test_quotient_count_matches_brute_force(log_n):
    n = 1 << log_n
    nnz, wires = 3 * n + 5, n + 2
    w = work.quotient_work(n, nnz, wires)
    assert w.products == 7 * brute_butterflies(n) + nnz
    assert w.bytes == nnz * 36 + 32 * (wires + 3 * n)


def test_least_time_is_the_larger_bound():
    ops = work.Work(products=1e6, bytes=1.0)
    assert ops.bound == "ops"
    assert ops.least_s == pytest.approx(
        1e6 * peaks.MULADDS_PER_MONT_MUL / peaks.INT32_MULADD_PER_S)
    mem = work.Work(products=1.0, bytes=1e9)
    assert mem.bound == "bytes"
    assert mem.least_s == pytest.approx(1e9 / peaks.HBM_BYTES_PER_S)
    assert peaks.INT32_MULADD_PER_S == pytest.approx(1.6727e13, rel=1e-4)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_full_width_count_equals_drawn_full_width_scalars(group):
    rng = random.Random(group)
    drawn = [rng.randrange(1 << 127, R) for _ in range(64)]
    bits = [rng.randrange(2) for _ in range(64)]
    assert work.msm_products(group, None, 64) == work.msm_products(
        group, limbs(drawn))
    assert work.msm_products(group, limbs(bits), 64) == work.msm_products(
        group, limbs(bits + drawn))


def test_scalar_limbs():
    vals = [0, 1, (1 << 255) + 7, R - 1]
    assert (work.scalar_limbs(vals).astype(np.int64)
            == limbs(vals).view(np.uint32).astype(np.int64)).all()
