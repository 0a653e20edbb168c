"""The port's field layer (zksnark_tpu_torch) against the JAX package.

Codecs between python ints, the port's u32 limbs and the JAX package's
f32 digits; the plain version of the montmul kernel K1 (what
`ops.montmul.mont_mul` runs on a CPU tensor) against the JAX limb path
`field.limb.mont_mul` and the Pallas kernel's math
(`mont_mul_pallas(..., interpret=True)`), for Fr and Fq.  Tolerance:
exact equality of the canonical residues, compared as JAX digits.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.field import limb as jlimb  # noqa: E402
from zksnark_tpu.ops.montmul import mont_mul_pallas  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.ops import montmul as mm  # noqa: E402

CTXS = {"Fr": (limb.FR_CTX, jlimb.FR_CTX), "Fq": (limb.FQ_CTX, jlimb.FQ_CTX)}


def _rand(seed, p, n):
    """n field elements from a numpy seed (python ints)."""
    raw = np.random.default_rng(seed).integers(
        0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a << 252 ^ b << 189 ^ c << 126 ^ d << 63 ^ e) % p
            for a, b, c, d, e in raw]


def _values(p, seed):
    """The edge values of the Pallas montmul test, the carry-ripple
    values of the device-field test, and a seeded sweep."""
    edge = [0, 1, p - 1, p - 2, (p - 1) // 2]
    ripple = [p - 1, (1 << 253) - 1, (1 << 208) - 1,
              0xFFFF * (1 + 2**16 + 2**32), 123, (1 << 160) - 1]
    xs = [x for x in edge for _ in edge] + ripple + _rand(seed, p, 48)
    ys = [y for _ in edge for y in edge] + ripple + _rand(seed + 1, p, 48)
    return xs, ys


def _port(ctx, xs):
    return torch.from_numpy(ctx.to_mont_np(xs))


def _as_jax(t):
    return limb.limbs_to_jax_np(t.numpy())


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_codec_roundtrips(field):
    ctx, jctx = CTXS[field]
    xs, _ = _values(ctx.p, 5)
    assert list(ctx.from_limbs_np(ctx.to_limbs_np(xs))) == xs
    assert list(ctx.from_mont_np(ctx.to_mont_np(xs))) == xs
    # the same residues: port limbs re-chunk to the JAX digits and back
    m = ctx.to_mont_np(xs)
    np.testing.assert_array_equal(limb.limbs_to_jax_np(m),
                                  jctx.to_mont_np(xs))
    np.testing.assert_array_equal(limb.limbs_from_jax_np(
        jctx.to_mont_np(xs)), m)
    u8 = jctx.to_limbs_np(xs).astype(np.uint8)   # a compressed-Z style array
    np.testing.assert_array_equal(limb.limbs_from_jax_np(u8),
                                  ctx.to_limbs_np(xs))


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_montmul_plain_matches_jax(field):
    ctx, jctx = CTXS[field]
    p = ctx.p
    xs, ys = _values(p, 11)
    before = dict(mm.LAUNCHES)
    got = _as_jax(mm.mont_mul(ctx, _port(ctx, xs), _port(ctx, ys)))
    assert mm.LAUNCHES == before          # a CPU tensor runs the plain path
    ax, ay = jnp.asarray(jctx.to_mont_np(xs)), jnp.asarray(jctx.to_mont_np(ys))
    np.testing.assert_array_equal(got, np.asarray(jlimb.mont_mul(jctx, ax, ay)))
    np.testing.assert_array_equal(
        got, np.asarray(mont_mul_pallas(jctx, ax, ay, interpret=True)))
    assert list(ctx.from_mont_np(limb.limbs_from_jax_np(got))) == \
        [x * y % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_add_sub_neg_match_jax(field):
    ctx, jctx = CTXS[field]
    xs, ys = _values(ctx.p, 17)
    a, b = _port(ctx, xs), _port(ctx, ys)
    ja, jb = jnp.asarray(jctx.to_mont_np(xs)), jnp.asarray(jctx.to_mont_np(ys))
    for mine, theirs in ((limb.add(ctx, a, b), jlimb.add(jctx, ja, jb)),
                         (limb.sub(ctx, a, b), jlimb.sub(jctx, ja, jb)),
                         (limb.neg(ctx, a), jlimb.neg(jctx, ja))):
        np.testing.assert_array_equal(_as_jax(mine), np.asarray(theirs))


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_to_from_mont_match_jax(field):
    ctx, jctx = CTXS[field]
    xs, _ = _values(ctx.p, 23)
    std = torch.from_numpy(ctx.to_limbs_np(xs))
    jstd = jnp.asarray(jctx.to_limbs_np(xs))
    np.testing.assert_array_equal(_as_jax(limb.to_mont(ctx, std)),
                                  np.asarray(jlimb.to_mont(jctx, jstd)))
    mont = _port(ctx, xs)
    np.testing.assert_array_equal(mm.from_mont(ctx, mont).numpy(),
                                  std.numpy())


def test_montmul_broadcasts_like_mont_mul_auto():
    ctx = limb.FR_CTX
    xs, ys = _rand(31, ctx.p, 6), _rand(32, ctx.p, 4)
    outer = mm.mont_mul(ctx, _port(ctx, xs)[:, None], _port(ctx, ys)[None])
    assert outer.shape == (6, 4, 8)
    want = [x * y % ctx.p for x in xs for y in ys]
    assert list(ctx.from_mont_np(outer.numpy()).reshape(-1)) == want


def test_montmul_wrapper_rejects_other_devices():
    a = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mm.mont_mul(limb.FR_CTX, a, a)


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_cuda_header_constants(field):
    """The modulus, Montgomery one and -p^-1 mod 2^32 written into
    csrc/bn254_field.cuh are those of field.params."""
    ctx = CTXS[field][0]
    src = (pathlib.Path(limb.__file__).parent.parent / "csrc" /
           "bn254_field.cuh").read_text()
    body = src[src.index(f"struct {field}Field"):]
    body = body[:body.index("};\n\nstruct") if field == "Fr" else None]
    n0 = int(re.search(r"N0 = (0x[0-9a-f]+)u", body).group(1), 16)
    arrays = re.findall(r"\[8\] = \{([^}]*)\}", body)
    words = [[int(w.strip().rstrip("u"), 16) for w in a.split(",")]
             for a in arrays]
    assert n0 == ctx.n0
    assert words[0] == [v & 0xFFFFFFFF for v in ctx._np["p"].tolist()]
    assert words[1] == [v & 0xFFFFFFFF for v in ctx._np["one"].tolist()]
