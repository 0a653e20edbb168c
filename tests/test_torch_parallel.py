"""The port's mesh path (`zksnark_tpu_torch.parallel`) on the CPU.

The ranks are subprocesses that import no JAX: one group of 2 gloo
ranks and one of 1, started together once for the module (ephemeral
port, one torch thread each, 300 s timeout) while the JAX side of the
comparisons runs here.  Each rank writes what it computed to a file.

- Against the JAX package directly: `ShardedDomain`'s twiddle tables,
  n^-1 and the `eval_perm` / `coeff_perm` layouts; `four_step_split`
  against JAX `_sharded_domain` and its assertion for n < d^2; the
  batched `ntt` / `intt` (plain path) against `jax.vmap` of JAX
  `ntt` / `intt`; and the gathered output of the 2 ranks' `ntt_sharded`
  at n = 16 against JAX `ntt_sharded` on a 2-device mesh.
- Transitively, through the port's single-device path (which the other
  `test_torch_*` files hold to JAX): `intt_sharded` by the round trip and
  against `ntt.intt` in natural order; `msm_sharded` (Pippenger and
  tree-sum modes, G1 and G2) against `msm` in affine form; the sharded
  CRS against `device_setup`'s point for point; the sharded proof
  (2 ranks and 1) byte-equal to `device_prove`'s with the same trapdoor
  and blinding, the same on every rank, and verified.
Tolerance: exact equality throughout (canonical residues).
"""

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from zksnark_tpu.ops import ntt as jntt  # noqa: E402
from zksnark_tpu.parallel import msm_sharded as jmsh  # noqa: E402
from zksnark_tpu.parallel import ntt_sharded as jnsh  # noqa: E402
from zksnark_tpu.parallel import prove_sharded as jpsh  # noqa: E402
from zksnark_tpu_torch.bench import synthetic_square_chain  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field import limb  # noqa: E402
from zksnark_tpu_torch.groth16 import protocol, prover  # noqa: E402
from zksnark_tpu_torch.groth16.backend import BN254Backend  # noqa: E402
from zksnark_tpu_torch.ops import msm as msmod  # noqa: E402
from zksnark_tpu_torch.ops import ntt  # noqa: E402
from zksnark_tpu_torch.parallel import ntt_sharded as nsh  # noqa: E402
from zksnark_tpu_torch.parallel import prove_sharded as psh  # noqa: E402
from zksnark_tpu_torch.utils import serialization as ser  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX = limb.FR_CTX
SEED = 61
LOG_N = 4                        # the square chain's domain: 15 gates
TRAPDOOR = (11, 22, 33, 44, 55)
BLINDING = (7, 9)
MSM_N = 16

# one rank: python -c RANK PORT WORLD RANK OUT
RANK = r"""
import sys
sys.path.insert(0, %(root)r)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from zksnark_tpu_torch.bench import synthetic_square_chain
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
from zksnark_tpu_torch.curve.jacobian import JPoint
from zksnark_tpu_torch.groth16 import prover
from zksnark_tpu_torch.parallel import msm_sharded as msh
from zksnark_tpu_torch.parallel import multihost
from zksnark_tpu_torch.parallel import ntt_sharded as nsh
from zksnark_tpu_torch.utils import serialization as ser

port, world, rank = map(int, sys.argv[1:4])
out = {}
multihost.init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")
multihost.init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")          # idempotent
mesh = multihost.global_mesh()
out["mesh"] = (mesh.rank, mesh.size, mesh.backend, str(mesh.device))
sl = multihost.host_local_slice(8 * world)
out["slice"] = (sl.start, sl.stop)
out["gather"] = mesh.all_gather(torch.full((2,), rank))
out["to_all"] = mesh.all_to_all(
    torch.arange(world * 3).reshape(world, 3) + 100 * rank)
sub = msh.make_mesh(1)
out["sub"] = None if sub is None else (sub.rank, sub.size)

if world > 1:
    inp = torch.load(sys.argv[5])
    for g, ops in (("g1", FQ_OPS), ("g2", FQ2_OPS)):
        pts = JPoint(*inp[g])
        pl = msh.shard_points(mesh, pts)
        sc = inp["scalars"][rank * len(pl.z):(rank + 1) * len(pl.z)]
        for pip in (True, False):
            out[f"msm_{g}_{pip}"] = tuple(msh.msm_sharded(
                ops, mesh, pl, sc, 4, use_pippenger=pip, affine=True))
    sd = nsh.ShardedDomain(2, 2, "cpu")
    d = mesh.size
    m = nsh.from_coeffs(sd, inp["coeffs"])
    c_l = nsh.ntt_sharded(mesh, sd, m[:, rank * 4 // d:(rank + 1) * 4 // d])
    out["ntt_c"] = mesh.all_gather(c_l).reshape(4, 4, 8)
    back = nsh.intt_sharded(mesh, sd, c_l)
    out["round_trip"] = mesh.all_gather(back)    # (d, n1, n2/d, 8)
    # natural evaluations e in C layout: C[k1][k2] = e[k1 + n1 k2]
    c_e = inp["evals"].reshape(4, 4, 8).transpose(0, 1).contiguous()
    m_e = nsh.intt_sharded(mesh, sd, c_e[rank * 4 // d:(rank + 1) * 4 // d])
    out["intt_m"] = mesh.all_gather(m_e)         # (d, n1, n2/d, 8)

r1cs, wit = synthetic_square_chain((1 << %(log_n)d) - 1)
dqap = prover.compile_r1cs(r1cs, device="cpu")
crs = prover.device_setup(dqap, trapdoor=%(trapdoor)r, mesh=mesh)
out["crs"] = [tuple(p) for p in (crs.xi_g1, crs.xi_t_g1, crs.sum_delta_g1,
                                 crs.xi_g2)]
out["sigma"] = ser.crs_to_json(crs.sigmag1, crs.sigmag2)
out["proof"] = ser.proof_to_json(prover.device_prove(
    dqap, crs, wit, blinding=%(blinding)r, mesh=mesh))
out["initialized"] = dist.is_initialized()
torch.save(out, sys.argv[4])
dist.destroy_process_group()
"""


def _rand(seed, n):
    raw = np.random.default_rng(seed).integers(
        0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a << 252 ^ b << 189 ^ c << 126 ^ d << 63 ^ e) % CTX.p
            for a, b, c, d, e in raw]


def _mont(vals):
    return torch.from_numpy(CTX.to_mont_np(vals))


def _jax(t):
    return jnp.asarray(limb.limbs_to_jax_np(t.numpy()))


def _eq_jax(port, jax_arr):
    np.testing.assert_array_equal(limb.limbs_to_jax_np(port.numpy()),
                                  np.asarray(jax_arr))


@functools.lru_cache(maxsize=None)
def _msm_inputs():
    """MSM_N affine G1 / G2 points (two at infinity), their scalars, the
    n = 16 coefficients and evaluations of the NTT checks."""
    rng = np.random.default_rng(SEED)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=MSM_N)]
    g1 = [None if i in (3, 11) else hc.g1_scalar_mul(hc.G1_GEN_PT, k)
          for i, k in enumerate(ks)]
    g2 = [None if i in (3, 11) else hc.g2_scalar_mul(hc.G2_GEN, k)
          for i, k in enumerate(ks)]
    scalars = _rand(SEED + 1, MSM_N)
    scalars[5] = 0
    return {
        "g1": tuple(prover._host_points_to_jac(FQ_OPS, g1, "cpu")),
        "g2": tuple(prover._host_points_to_jac(FQ2_OPS, g2, "cpu")),
        "scalars": torch.from_numpy(CTX.to_limbs_np(scalars)),
        "coeffs": _mont(_rand(SEED + 2, 16)),
        "evals": _mont(_rand(SEED + 3, 16)),
    }


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """The two groups (2 ranks, 1 rank), started at the module's start."""
    tmp = tmp_path_factory.mktemp("ranks")
    inp = tmp / "inputs.pt"
    torch.save(_msm_inputs(), inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    prog = RANK % {"root": ROOT, "log_n": LOG_N, "trapdoor": TRAPDOOR,
                   "blinding": BLINDING}
    procs = {}
    for world in (2, 1):
        port = _port()
        for rank in range(world):
            out = tmp / f"w{world}r{rank}.pt"
            procs[(world, rank)] = (subprocess.Popen(
                [sys.executable, "-c", prog, str(port), str(world),
                 str(rank), str(out), str(inp)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=tmp), out)
    yield procs
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(launched):
    """{(world, rank): what the rank wrote}."""
    got = {}
    try:
        for key, (p, out) in launched.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {key}:\n{err[-3000:]}"
            got[key] = torch.load(out, weights_only=False)
    finally:
        for p, _ in launched.values():
            if p.poll() is None:
                p.kill()
    return got


@pytest.fixture(scope="module")
def single():
    """The single-device CRS and proof of the same circuit, trapdoor and
    blinding."""
    r1cs, wit = synthetic_square_chain((1 << LOG_N) - 1)
    dqap = prover.compile_r1cs(r1cs, device="cpu")
    crs = prover.device_setup(dqap, trapdoor=TRAPDOOR)
    proof = prover.device_prove(dqap, crs, wit, blinding=BLINDING)
    return crs, proof, wit


# ---------------------------------------------------------------------------
# against the JAX package, directly
# ---------------------------------------------------------------------------

def test_importing_parallel_starts_no_process_group():
    import torch.distributed as dist

    from zksnark_tpu_torch.parallel import msm_sharded, multihost  # noqa
    assert not dist.is_initialized()


@pytest.mark.parametrize("log_n1,log_n2,d", [(2, 2, 1), (2, 2, 2),
                                             (2, 3, 2), (3, 3, 4)])
def test_sharded_domain_matches_jax(log_n1, log_n2, d):
    sd = nsh.ShardedDomain(log_n1, log_n2, "cpu")
    jsd = jnsh.ShardedDomain(log_n1, log_n2)
    assert sd.tw.shape == (sd.n2, sd.n1, 8)
    _eq_jax(sd.tw, jsd.tw)
    _eq_jax(sd.tw_inv, jsd.tw_inv)
    _eq_jax(sd.n_inv_mont, jsd.n_inv_mont)
    np.testing.assert_array_equal(nsh.eval_perm(sd, d),
                                  jnsh.eval_perm(jsd, d))
    np.testing.assert_array_equal(nsh.coeff_perm(sd, d),
                                  jnsh.coeff_perm(jsd, d))


@pytest.mark.parametrize("log_n,d", [(2, 1), (4, 2), (5, 2), (4, 4),
                                     (7, 4), (9, 8)])
def test_four_step_split_matches_jax(log_n, d):
    j = jpsh._sharded_domain(log_n, d)
    assert psh.four_step_split(log_n, d) == (j.log_n1, j.log_n2)


@pytest.mark.parametrize("log_n,d", [(2, 4), (3, 4), (5, 8), (4, 3)])
def test_four_step_split_refuses_like_jax(log_n, d):
    with pytest.raises(AssertionError):
        jpsh._sharded_domain(log_n, d)
    with pytest.raises(AssertionError):
        psh.four_step_split(log_n, d)


@pytest.mark.parametrize("log_n", [1, 3, 5])
def test_batched_transforms_match_jax_vmap(log_n):
    n = 1 << log_n
    d = ntt.get_domain(log_n, "cpu")
    jd = jntt.get_domain(log_n)
    x = _mont(_rand(100 + log_n, 4 * n)).reshape(4, n, 8)
    jx = _jax(x)
    want_f, want_i = jax.jit(lambda a: (
        jax.vmap(lambda v: jntt.ntt(jd, v))(a),
        jax.vmap(lambda v: jntt.intt(jd, v))(a)))(jx)
    _eq_jax(ntt.ntt(d, x), want_f)
    _eq_jax(ntt.intt(d, x), want_i)


def test_ntt_sharded_matches_jax(request):
    """The gathered C of the port's 2 gloo ranks against JAX
    `ntt_sharded` on 2 of the 8 virtual devices, at n = 16 (the JAX side
    first: it compiles while the ranks run)."""
    coeffs = _msm_inputs()["coeffs"]
    jsd = jnsh.ShardedDomain(2, 2)
    mesh = jmsh.make_mesh(2)
    want = np.asarray(jnsh.ntt_sharded(
        mesh, jsd, jnsh.from_coeffs(jsd, _jax(coeffs))))
    ranks = request.getfixturevalue("ranks")
    _eq_jax(ranks[(2, 0)]["ntt_c"], want)
    assert torch.equal(ranks[(2, 1)]["ntt_c"], ranks[(2, 0)]["ntt_c"])


# ---------------------------------------------------------------------------
# the ranks' runtime
# ---------------------------------------------------------------------------

def test_mesh_and_slices(ranks):
    for (world, rank), got in ranks.items():
        assert got["mesh"] == (rank, world, "gloo", "cpu")
        assert got["slice"] == (8 * rank, 8 * rank + 8)
        assert got["initialized"]


def test_all_gather_and_all_to_all(ranks):
    for (world, rank), got in ranks.items():
        assert got["gather"].tolist() == [[r, r] for r in range(world)]
        # row j came from rank j: its row `rank`
        assert got["to_all"].tolist() == [
            [100 * j + 3 * rank + i for i in range(3)] for j in range(world)]


def test_make_mesh_sub_group(ranks):
    assert ranks[(2, 0)]["sub"] == (0, 1)
    assert ranks[(2, 1)]["sub"] is None
    assert ranks[(1, 0)]["sub"] == (0, 1)


# ---------------------------------------------------------------------------
# transitively, against the port's single-device path
# ---------------------------------------------------------------------------

def _columns(gathered):
    """(d, n1, n2/d, 8) column blocks -> (n1, n2, 8)."""
    return torch.cat(list(gathered), dim=1)


def test_ntt_sharded_to_natural_matches_ntt(ranks):
    sd = nsh.ShardedDomain(2, 2, "cpu")
    coeffs = _msm_inputs()["coeffs"]
    assert torch.equal(nsh.to_natural(sd, ranks[(2, 0)]["ntt_c"]),
                       ntt.ntt(ntt.get_domain(4, "cpu"), coeffs))


def test_intt_sharded_round_trip(ranks):
    coeffs = _msm_inputs()["coeffs"]
    for rank in (0, 1):
        got = _columns(ranks[(2, rank)]["round_trip"])
        assert torch.equal(got.reshape(16, 8), coeffs)


def test_intt_sharded_matches_intt(ranks):
    evals = _msm_inputs()["evals"]
    got = _columns(ranks[(2, 0)]["intt_m"])
    assert torch.equal(got.reshape(16, 8),
                       ntt.intt(ntt.get_domain(4, "cpu"), evals))


@pytest.mark.parametrize("g", ["g1", "g2"])
@pytest.mark.parametrize("pippenger", [True, False])
def test_msm_sharded_matches_msm(ranks, g, pippenger):
    ops = FQ_OPS if g == "g1" else FQ2_OPS
    inp = _msm_inputs()
    want = jac.to_affine_np(ops, msmod.msm(
        ops, jac.JPoint(*inp[g]), inp["scalars"], 4, True))
    for rank in (0, 1):
        got = ranks[(2, rank)][f"msm_{g}_{pippenger}"]
        assert jac.to_affine_np(ops, jac.JPoint(*got)) == want


@pytest.mark.parametrize("piece", range(4))
@pytest.mark.parametrize("world", [2, 1])
def test_sharded_crs_matches_device_setup(ranks, single, piece, world):
    crs = single[0]
    want = (crs.xi_g1, crs.xi_t_g1, crs.sum_delta_g1, crs.xi_g2)[piece]
    for rank in range(world):
        got = ranks[(world, rank)]["crs"][piece]
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_sharded_crs_host_parts_match(ranks, single):
    crs = single[0]
    want = ser.crs_to_json(crs.sigmag1, crs.sigmag2)
    for got in ranks.values():
        assert got["sigma"] == want


@pytest.mark.parametrize("world", [2, 1])
def test_sharded_proof_is_byte_equal(ranks, single, world):
    want = ser.proof_to_json(single[1])
    for rank in range(world):
        assert ranks[(world, rank)]["proof"] == want


def test_sharded_proof_verifies(ranks, single):
    crs, _, wit = single
    proof = ser.proof_from_json(ranks[(2, 1)]["proof"])
    pair = (crs.sigmag1, crs.sigmag2)
    be = BN254Backend()
    assert protocol.verify_fast(be, pair, [wit[1]], proof)
    assert not protocol.verify_fast(be, pair, [wit[1] + 1], proof)
