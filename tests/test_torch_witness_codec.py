"""The native witness codec (`zksnark_tpu_torch/csrc/witness_codec.c`,
`field/witness_codec.py`, `MontCtx.witness_limbs`) against its reference,
`MontCtx.to_limbs_np` of the weights padded with zeros: the same bytes on
edge values, numpy integers, random full-width and 0/1 witnesses, tuples,
iterators and padding; the values it reduces with Python's `%` counted;
errors raised as `int(x) % p` raises them; and the Python codec, where
the library is not there, byte-equal.  CPU only, at most 2^12 wires.
"""

import random
import sys

import numpy as np
import pytest

from zksnark_tpu_torch.field import witness_codec
from zksnark_tpu_torch.field.limb import FQ_CTX, FR_CTX

P = FR_CTX.p
EDGES = [0, 1, P - 1, P, P + 1, 2 ** 63 - 1, 2 ** 64 - 1, 2 ** 64,
         2 ** 255, 2 ** 256 - 1, 2 ** 256, 2 ** 300, -1, -P, True]


def _slow(x, p) -> bool:
    """Whether the native codec takes `int(x) % p` for x."""
    return not (type(x) in (int, bool) and 0 <= x < p)


def _reference(ctx, weights, num_wires):
    w = list(weights)
    return ctx.to_limbs_np(w + [0] * (num_wires - len(w)))


def _check(ctx, weights, num_wires):
    limbs, codec, reduced = ctx.witness_limbs(weights, num_wires)
    assert codec == "native"
    assert limbs.dtype == np.int32 and limbs.shape == (num_wires, 8)
    np.testing.assert_array_equal(limbs, _reference(ctx, weights, num_wires))
    assert reduced == sum(_slow(x, ctx.p) for x in weights)


@pytest.fixture(scope="module", autouse=True)
def _native():
    assert witness_codec._load() is not None, "the native codec did not build"


@pytest.mark.parametrize("x", EDGES + [np.int64(-5), np.int64(2 ** 62),
                                       np.uint64(2 ** 64 - 1), 3.7, "12"],
                         ids=repr)
def test_one_value(x):
    """Each value alone, in a row of its own among zeros: `int(x) % p`."""
    _check(FR_CTX, [7, x, 5], 4)


def _full(rng, ctx, n):
    return [rng.randrange(ctx.p) for _ in range(n)]


CASES = {
    "edges": lambda rng, ctx: EDGES * 3,
    "full_width": lambda rng, ctx: _full(rng, ctx, 1 << 12),
    "bits": lambda rng, ctx: [rng.randrange(2) for _ in range(1 << 12)],
    "words": lambda rng, ctx: [rng.randrange(1 << rng.choice((1, 30, 32, 60,
                                                              64, 128)))
                               for _ in range(1 << 12)],
    "unreduced": lambda rng, ctx: [rng.randrange(-4 * ctx.p, 4 * ctx.p)
                                   for _ in range(1 << 10)],
    "tuple": lambda rng, ctx: tuple(_full(rng, ctx, 1 << 8)),
    "empty": lambda rng, ctx: [],
}


@pytest.mark.parametrize("ctx", [FR_CTX, FQ_CTX], ids=["fr", "fq"])
@pytest.mark.parametrize("pad", [0, 1, 37])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_to_limbs_np(case, pad, ctx):
    weights = CASES[case](random.Random(f"{case}-{pad}"), ctx)
    _check(ctx, weights, len(weights) + pad)


def test_iterator_input():
    rng = random.Random(3)
    weights = _full(rng, FR_CTX, 100) + [-1, P]
    limbs, codec, reduced = FR_CTX.witness_limbs(iter(weights), 110)
    np.testing.assert_array_equal(limbs, _reference(FR_CTX, weights, 110))
    assert (codec, reduced) == ("native", 2)


def test_counts_and_references():
    """`reduced` counts the slow values alone, and no value's reference
    count moves."""
    big, neg = P + 12345, -(2 ** 200)
    weights = [big, 1, neg, 2 ** 70, np.int64(3), 0, P - 1, big]
    before = [sys.getrefcount(x) for x in (big, neg)]
    _, _, reduced = FR_CTX.witness_limbs(weights, 10)
    assert reduced == 4
    assert [sys.getrefcount(x) for x in (big, neg)] == before


def test_more_weights_than_wires_raise():
    with pytest.raises(ValueError, match="4 weights for 3 wires"):
        FR_CTX.witness_limbs([1, 2, 3, 4], 3)


BAD = {"none": None, "str": "abc", "object": object(), "inf": float("inf"),
       "nan": float("nan"), "list": [1]}


@pytest.mark.parametrize("bad", list(BAD.values()), ids=list(BAD))
def test_bad_values_raise_as_python(bad):
    with pytest.raises(Exception) as want:
        int(bad) % P
    with pytest.raises(want.type) as got:
        FR_CTX.witness_limbs([1, 2, bad, 4], 5)
    assert str(got.value) == str(want.value)


def test_python_fallback(monkeypatch):
    """Without the library, the Python codec runs: the same bytes and
    errors, every weight reduced with `%`."""
    rng = random.Random(5)
    weights = EDGES + _full(rng, FR_CTX, 200) + [np.uint64(9)]
    native, _, _ = FR_CTX.witness_limbs(weights, len(weights) + 3)
    monkeypatch.setattr(witness_codec, "_load", lambda: None)
    limbs, codec, reduced = FR_CTX.witness_limbs(weights, len(weights) + 3)
    assert (codec, reduced) == ("python", len(weights))
    np.testing.assert_array_equal(limbs, native)
    with pytest.raises(ValueError, match="4 weights for 3 wires"):
        FR_CTX.witness_limbs([1, 2, 3, 4], 3)
    with pytest.raises(TypeError):
        FR_CTX.witness_limbs([1, None], 3)
