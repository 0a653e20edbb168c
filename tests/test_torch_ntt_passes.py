"""The port's NTT in passes against the JAX package.

`zksnark_tpu_torch.ops.ntt` runs the DIT stages in passes: stages
s0 .. s0 + k - 1 act on independent groups of 2^k elements, one kernel
launch per pass on the card and, on CPU tensors, the plain version
`butterflies_plain` with the kernel's group and twiddle index
arithmetic.  At log_n in {1, 5, 10, 11, 13} the domain's `ntt`, `intt`,
`coset_ntt` and `coset_intt` (the default split) and the butterflies in
passes that split log_n unevenly (and in an order the default split
would not take), forward and, with the n^-1 product, inverse, must
equal `zksnark_tpu.ops.ntt` bit for bit.  The coset and n^-1 products
around the butterflies do not depend on the split, so the uneven splits
are held against `ntt` and `intt` alone.  Inputs come from a numpy
seed.  Tolerance: exact equality of canonical residues.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from zksnark_tpu.ops import ntt as jntt  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.ops import ntt  # noqa: E402
from zksnark_tpu_torch.ops.montmul import mont_mul  # noqa: E402

CTX = limb.FR_CTX
TRANSFORMS = ("ntt", "intt", "coset_ntt", "coset_intt")
# (log_n, pass widths): one pass of one stage; 4 + 1; 3 + 7; 10 + 1; three
# uneven passes
CASES = [(1, (1,)), (5, (4, 1)), (10, (3, 7)), (11, (10, 1)),
         (13, (2, 8, 3))]


def _rand(seed, n):
    raw = np.random.default_rng(seed).integers(
        0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a << 252 ^ b << 189 ^ c << 126 ^ d << 63 ^ e) % CTX.p
            for a, b, c, d, e in raw]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"log_n{n}-{'+'.join(map(str, w))}" for n, w in CASES])
def case(request):
    """(port domain, uneven pass widths, input, the JAX package's four
    transforms of it; dispatched first, they run while the port
    computes)."""
    log_n, widths = request.param
    jd = jntt.get_domain(log_n)
    m = CTX.to_mont_np(_rand(500 + log_n, 1 << log_n))
    want = jax.jit(lambda a: tuple(getattr(jntt, f)(jd, a)
                                   for f in TRANSFORMS))(
        jnp.asarray(limb.limbs_to_jax_np(m)))
    return ntt.Domain(log_n, "cpu"), widths, torch.from_numpy(m), \
        dict(zip(TRANSFORMS, want))


@pytest.mark.parametrize("fn", TRANSFORMS)
def test_pass_form_matches_jax(case, fn):
    d, _, x, want = case
    np.testing.assert_array_equal(
        limb.limbs_to_jax_np(getattr(ntt, fn)(d, x).numpy()),
        np.asarray(want[fn]))


@pytest.mark.parametrize("fn", ("ntt", "intt"))
def test_uneven_passes_match_jax(case, fn):
    """The butterflies in the case's uneven passes: forward with the
    twiddle table, inverse with the inverse table and the n^-1 product."""
    d, widths, x, want = case
    tw = d.t.tw_table if fn == "ntt" else d.t.tw_table_inv
    got = ntt.butterflies(CTX, d.log_n, tw, x, widths)
    if fn == "intt":
        got = mont_mul(CTX, got, d.t.n_inv_mont.unsqueeze(0))
    np.testing.assert_array_equal(limb.limbs_to_jax_np(got.numpy()),
                                  np.asarray(want[fn]))


def test_pass_widths():
    """The default split: ceil(log_n / 10) passes of 1..10 stages that
    differ by at most one, for every size a domain takes."""
    for log_n in range(1, 29):
        w = ntt.pass_widths(log_n)
        assert sum(w) == log_n and len(w) == -(-log_n // 10)
        assert max(w) <= 10 and max(w) - min(w) <= 1
    assert ntt.pass_widths(20) == (10, 10)
    assert ntt.pass_widths(13) == (7, 6)
