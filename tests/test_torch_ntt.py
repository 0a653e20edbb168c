"""The port's NTT and field scans against the JAX package.

`ntt` / `intt` / `coset_ntt` / `coset_intt` / `divide_by_vanishing` of
`zksnark_tpu_torch.ops.ntt` (every multiply on the montmul kernel K1's
plain version here) bit for bit against `zksnark_tpu.ops.ntt` and the
JAX package's host DFT oracle for n = 2^2 .. 2^8, `divide_by_vanishing`
against an exact host quotient at every size and against the JAX one at
two (each JAX size is an XLA compile);
`field_prefix_scan` / `field_segment_sums` against `zksnark_tpu.ops.scans`.
Inputs come from a numpy seed.  Tolerance: exact equality of canonical
residues (the two packages hold the same Montgomery residues).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from zksnark_tpu.field import limb as jlimb  # noqa: E402
from zksnark_tpu.field.host import FR  # noqa: E402
from zksnark_tpu.ops import ntt as jntt  # noqa: E402
from zksnark_tpu.ops import scans as jscans  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.ops import ntt  # noqa: E402
from zksnark_tpu_torch.ops import scans  # noqa: E402

CTX = limb.FR_CTX


def _rand(seed, n):
    raw = np.random.default_rng(seed).integers(
        0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a << 252 ^ b << 189 ^ c << 126 ^ d << 63 ^ e) % CTX.p
            for a, b, c, d, e in raw]


def _both(vals):
    m = CTX.to_mont_np(vals)
    return torch.from_numpy(m), jnp.asarray(limb.limbs_to_jax_np(m))


def _eq(port, jax_arr):
    np.testing.assert_array_equal(limb.limbs_to_jax_np(port.numpy()),
                                  np.asarray(jax_arr))


@pytest.mark.parametrize("log_n", range(2, 9))
def test_transforms_match_host_dft(log_n):
    """Every size against the JAX package's host oracle (the naive DFT of
    `zksnark_tpu.field.host`, which tests/test_ntt.py holds the JAX NTT
    to)."""
    n = 1 << log_n
    d = ntt.get_domain(log_n, "cpu")
    jd = jntt.get_domain(log_n)
    assert (d.omega, d.coset_gen, d.coset_vanishing) == \
        (jd.omega, jd.coset_gen, jd.coset_vanishing)
    vals = _rand(log_n, n)
    x, _ = _both(vals)
    p, g = CTX.p, d.coset_gen

    def host(t):
        return [int(v) for v in CTX.from_mont_np(t.numpy())]

    assert host(ntt.ntt(d, x)) == FR.dft(vals, d.omega)
    assert host(ntt.intt(d, x)) == FR.idft(vals, d.omega)
    scaled = [v * pow(g, i, p) % p for i, v in enumerate(vals)]
    assert host(ntt.coset_ntt(d, x)) == FR.dft(scaled, d.omega)
    gi = pow(g, -1, p)
    assert host(ntt.coset_intt(d, x)) == [
        v * pow(gi, i, p) % p for i, v in enumerate(FR.idft(vals, d.omega))]


@pytest.mark.parametrize("log_n", range(2, 9))
def test_transforms_match_jax(log_n):
    n = 1 << log_n
    d = ntt.get_domain(log_n, "cpu")
    jd = jntt.get_domain(log_n)
    x, jx = _both(_rand(log_n, n))
    want = jax.jit(lambda a: (jntt.ntt(jd, a), jntt.intt(jd, a),
                              jntt.coset_ntt(jd, a),
                              jntt.coset_intt(jd, a)))(jx)
    got = (ntt.ntt(d, x), ntt.intt(d, x), ntt.coset_ntt(d, x),
           ntt.coset_intt(d, x))
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
    assert torch.equal(ntt.intt(d, ntt.ntt(d, x)), x)


@pytest.mark.parametrize("log_n", range(2, 9))
def test_divide_by_vanishing_exact_quotient(log_n):
    """A satisfied instance (w = u*v on the domain): h is the exact
    quotient (u*v - w) / (x^n - 1), computed on the host."""
    n = 1 << log_n
    d = ntt.get_domain(log_n, "cpu")
    p = CTX.p
    ue, ve = _rand(200 + log_n, n), _rand(300 + log_n, n)
    we = [a * b % p for a, b in zip(ue, ve)]
    u_c, v_c, w_c = (ntt.intt(d, _both(e)[0]) for e in (ue, ve, we))
    h = ntt.divide_by_vanishing(d, u_c, v_c, w_c)
    uh, vh, wh = (FR.idft(e, d.omega) for e in (ue, ve, we))
    num = [0] * (2 * n - 1)
    for i, a in enumerate(uh):
        for j, b in enumerate(vh):
            num[i + j] = (num[i + j] + a * b) % p
    for i, c in enumerate(wh):
        num[i] = (num[i] - c) % p
    # num = num_hi * (x^n - 1) + (num_lo + num_hi), and the remainder is 0
    assert all((num[i] + (num[n + i] if i < n - 1 else 0)) % p == 0
               for i in range(n))
    assert [int(v) for v in CTX.from_mont_np(h.numpy())] == num[n:] + [0]


@pytest.mark.parametrize("log_n", [3, 8])
def test_divide_by_vanishing_matches_jax(log_n):
    """Random (unsatisfied) inputs: the port's quotient takes the
    coefficients the prover already has; the JAX one takes evaluations and
    runs those iNTTs itself."""
    n = 1 << log_n
    d = ntt.get_domain(log_n, "cpu")
    jd = jntt.get_domain(log_n)
    (u, ju), (v, jv), (w, jw) = (_both(_rand(100 + log_n + k, n))
                                 for k in range(3))
    want = jntt.divide_by_vanishing(jd, ju, jv, jw)
    got = ntt.divide_by_vanishing(d, ntt.intt(d, u), ntt.intt(d, v),
                                  ntt.intt(d, w))
    _eq(got, want)


@pytest.mark.parametrize("n", [5, 128, 300])
def test_field_prefix_scan_matches_jax(n):
    x, jx = _both(_rand(7 + n, n))
    _eq(scans.field_prefix_scan(CTX, x),
        jscans.field_prefix_scan(jlimb.FR_CTX, jx))


def test_field_segment_sums_matches_jax():
    rng = np.random.default_rng(3)
    n_seg, n_ent = 40, 333
    keys = rng.integers(0, n_seg, size=n_ent)
    keys[keys == 7] = 8                     # an empty segment
    x, jx = _both(_rand(9, n_ent))
    got = scans.field_segment_sums(CTX, torch.from_numpy(keys), x, n_seg)
    want = jscans.field_segment_sums(jlimb.FR_CTX, jnp.asarray(keys), jx,
                                     n_seg)
    _eq(got, want)
    vals = _rand(9, n_ent)
    sums = [0] * n_seg
    for k, v in zip(keys.tolist(), vals):
        sums[k] = (sums[k] + v) % CTX.p
    assert list(CTX.from_mont_np(got.numpy())) == sums
