"""The proof's blinding (r, s) folded into the device MSMs
(`zksnark_tpu_torch.groth16.prover`), on the CPU (every kernel replaced by
its plain version).

- On simple.zk under the pinned trapdoor of tests/test_torch_prover.py,
  the folded `device_prove` equals the host `protocol.prove` of the JAX
  package and of the port (the blinding's scalar multiplications on the
  host) bit for bit, for the blindings (7, 9), (1, 1), full-width from a
  seeded rng and r s = 1 mod r, and for the all-zero witness, whose MSMs
  have no term but the appended ones (A's own MSM is the point at
  infinity).  The JAX package's `device_prove` equals its host prove
  (tests/test_device_prover.py) and the port's `device_prove`
  (tests/test_torch_prover.py), each a ~17 s CPU run a blinding, so it is
  not run again here.
- A CRS carried by `crs_from_jax_arrays` has no prove sets until its first
  prove builds them and their window tables; it proves the same proof.
  The MSMs over the tables give the windowed MSMs' points.
- With the host's `g1_scalar_mul` and `g2_scalar_mul` made to raise,
  `device_prove` still proves, on one device and on a mesh of two gloo
  ranks (subprocesses started at the module's start), the square chain
  at 7 gates: each proof equals the host protocol's unfolded proof for
  the same trapdoor and blinding.
Tolerance: exact equality.
"""

import dataclasses
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.field.host import FR as JFR  # noqa: E402
from zksnark_tpu.frontend import compiler as jcompiler  # noqa: E402
from zksnark_tpu.frontend import witness as jwitness  # noqa: E402
from zksnark_tpu.frontend.r1cs import R1CS as JR1CS  # noqa: E402
from zksnark_tpu.groth16 import protocol as jprotocol  # noqa: E402
from zksnark_tpu.groth16.backend import BN254Backend as JBackend  # noqa: E402
from zksnark_tpu.groth16.qap import from_r1cs as jfrom_r1cs  # noqa: E402
from zksnark_tpu_torch.bench import synthetic_square_chain  # noqa: E402
from zksnark_tpu_torch.curve import bn254 as hc  # noqa: E402
from zksnark_tpu_torch.curve import jacobian as jac  # noqa: E402
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS  # noqa: E402
from zksnark_tpu_torch.field.host import FR  # noqa: E402
from zksnark_tpu_torch.frontend.r1cs import R1CS  # noqa: E402
from zksnark_tpu_torch.groth16 import protocol, prover  # noqa: E402
from zksnark_tpu_torch.groth16.backend import BN254Backend  # noqa: E402
from zksnark_tpu_torch.groth16.qap import from_r1cs  # noqa: E402
from zksnark_tpu_torch.ops import msm  # noqa: E402
from zksnark_tpu_torch.utils import profiling  # noqa: E402
from zksnark_tpu_torch.utils import serialization as ser  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = (111, 222, 333, 444, 555)
P = FR.p
_rng = random.Random(20261018)
_r = _rng.randrange(1, P)
BLINDINGS = {
    "pinned": (7, 9),
    "ones": (1, 1),
    "full_width": (_rng.randrange(1, P), _rng.randrange(1, P)),
    "rs_is_one": (_r, pow(_r, -1, P)),
}
CHAIN_GATES = 7
CHAIN_BL = (_rng.randrange(1, P), _rng.randrange(1, P))
torch.set_num_threads(1)     # small tensors: threads only add overhead

# one mesh rank: python -c RANK PORT RANK OUT; proves the square chain with
# the host's scalar multiplications raising
RANK = r"""
import sys
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from zksnark_tpu_torch.bench import synthetic_square_chain
from zksnark_tpu_torch.curve import bn254 as hc
from zksnark_tpu_torch.groth16 import prover
from zksnark_tpu_torch.parallel import multihost
from zksnark_tpu_torch.utils import serialization as ser

port, rank = map(int, sys.argv[1:3])
multihost.init_distributed(f"tcp://127.0.0.1:{port}", 2, rank,
                           device="cpu")
mesh = multihost.global_mesh()
r1cs, wit = synthetic_square_chain(%(gates)d)
dqap = prover.compile_r1cs(r1cs, device="cpu")
crs = prover.device_setup(dqap, trapdoor=%(trapdoor)r, mesh=mesh)


def raise_(*args):
    raise AssertionError("a host scalar multiplication in device_prove")


hc.g1_scalar_mul = hc.g2_scalar_mul = raise_
proof = prover.device_prove(dqap, crs, wit, blinding=%(blinding)r,
                            mesh=mesh)
with open(sys.argv[3], "w") as f:
    f.write(ser.proof_to_json(proof))
dist.destroy_process_group()
"""


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def mesh_ranks(tmp_path_factory):
    """The two mesh ranks, started at the module's start; their proofs'
    JSON once they have ended."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    prog = RANK % {"root": ROOT, "gates": CHAIN_GATES, "trapdoor": TD,
                   "blinding": CHAIN_BL}
    port = _port()
    procs = [(subprocess.Popen(
        [sys.executable, "-c", prog, str(port), str(rank),
         str(tmp / f"r{rank}.json")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=tmp),
        tmp / f"r{rank}.json") for rank in range(2)]

    def proofs():
        out = []
        for p, path in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            out.append(path.read_text())
        return out

    yield proofs
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _host_reference(r1cs, dq, pkg="port"):
    """A host protocol's QAP over `dq`'s domain and its host CRS for TD:
    the port's, or the JAX package's (pkg="jax")."""
    roots = prover.domain_roots(dq.domain)
    mods = {"port": (R1CS, BN254Backend, from_r1cs, FR, protocol),
            "jax": (JR1CS, JBackend, jfrom_r1cs, JFR, jprotocol)}
    r1cs_t, backend, qap_of, field, proto = mods[pkg]
    host_r1cs = r1cs_t(
        u=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.u],
        v=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.v],
        w=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.w],
        roots=roots, input=r1cs.input)
    be = backend()
    qap = qap_of(field, host_r1cs)
    return proto, be, qap, proto.setup(be, qap, trapdoor=TD)


def _host_prove(ref, w, blinding):
    proto, be, qap, crs = ref
    return proto.prove(be, qap, crs, w, blinding=blinding)


@pytest.fixture(scope="module")
def simple():
    code = open("test_programs/simple.zk").read()
    jr1cs = jcompiler.parse(code, JFR)
    w = jwitness.weights(code, [3, 2, 4], JFR)
    r1cs = R1CS(u=jr1cs.u, v=jr1cs.v, w=jr1cs.w, roots=jr1cs.roots,
                input=jr1cs.input)
    dq = prover.compile_r1cs(r1cs, device="cpu")
    crs = prover.device_setup(dq, trapdoor=TD)
    return dict(w=w, dq=dq, crs=crs,
                hosts=[_host_reference(r1cs, dq, pkg)
                       for pkg in ("jax", "port")])


def _tuple(p):
    return (p.a, p.b, p.c)


CASES = [(name, "witness", bl) for name, bl in BLINDINGS.items()] + [
    ("zero_witness", "zeros", (7, 9))]


@pytest.mark.parametrize("name,wit,blinding", CASES,
                         ids=[c[0] for c in CASES])
def test_folded_prove_equals_jax_and_host(simple, name, wit, blinding):
    w = simple["w"] if wit == "witness" else [0] * len(simple["w"])
    proof = prover.device_prove(simple["dq"], simple["crs"], w,
                                blinding=blinding)
    jax_host, port_host = (_host_prove(ref, w, blinding)
                           for ref in simple["hosts"])
    assert _tuple(proof) == _tuple(jax_host) == _tuple(port_host)
    if wit == "witness":
        pair = (simple["crs"].sigmag1, simple["crs"].sigmag2)
        assert protocol.verify_fast(BN254Backend(), pair, [2, 34], proof)


def test_carried_crs_builds_its_sets_at_first_prove(simple, tmp_path):
    """The port's CRS through the JAX package's `.npz` checkpoint and back
    by `crs_from_jax_arrays`: its first prove builds its sets and their
    window tables (`prove.issue`'s `msm_tables` reads 5)."""
    path = str(tmp_path / "port_crs.npz")
    ser.device_crs_save(path, simple["crs"])
    with np.load(path) as f:
        carried = ser.crs_from_jax_arrays(
            *((f[k + "_x"], f[k + "_y"], f[k + "_z"])
              for k in ("xi_g1", "xi_t", "sd", "xi_g2")),
            *ser.host_crs_load(path), device="cpu")
    assert carried.sets is None
    before = carried.xi_g1
    blinding = BLINDINGS["full_width"]
    profiling.clear_spans()
    with profiling.tracing():
        proof = prover.device_prove(simple["dq"], carried, simple["w"],
                                    blinding=blinding)
    issue = [s for s in profiling.spans() if s.name == "prove.issue"]
    profiling.clear_spans()
    assert carried.sets is not None
    assert carried.xi_g1.x.data_ptr() == carried.sets.xi_g1.x.data_ptr()
    for a, b in zip(carried.xi_g1, before):
        assert torch.equal(a, b)
    assert [s.attrs["msm_tables"] for s in issue] == [prover.PROVE_MSMS]
    tables = carried.sets.tables
    assert tables.window_bits == msm.pick_window_bits(simple["dq"].n)
    assert carried.xi_g2.x.data_ptr() == tables.g2.x.data_ptr()
    assert _tuple(proof) == _tuple(
        _host_prove(simple["hosts"][1], simple["w"], blinding))


def test_table_msms_equal_the_windowed_msms(simple):
    """`_prove_core` over the CRS's window tables and in the windowed
    formulation (`msm_windowed_batch`, `msm_windowed`) on the same sets
    and scalars: the same five points in affine form, so the same A, B
    and C."""
    dq = simple["dq"]
    sets = prover.prove_sets(simple["crs"])
    assert sets.tables is not None
    limbs, _, _ = prover.FR_CTX.witness_limbs(simple["w"], dq.num_wires)
    wm = prover.mont_mul(prover.FR_CTX, torch.from_numpy(limbs),
                         prover.FR_CTX.const("r2", "cpu"))
    blind = torch.from_numpy(prover._blinding_limbs(*BLINDINGS["full_width"]))
    args = (dq.domain, dq.input, msm.pick_window_bits(dq.n),
            (dq.u, dq.v, dq.w))
    tabled = prover._prove_core(*args, sets, wm, blind)
    windowed = prover._prove_core(
        *args, dataclasses.replace(sets, tables=None), wm, blind)
    for ops, a, b in zip((FQ_OPS, FQ_OPS, FQ2_OPS, FQ_OPS, FQ_OPS), tabled,
                         windowed):
        assert jac.to_affine_np(ops, a) == jac.to_affine_np(ops, b)


@pytest.fixture(scope="module")
def chain():
    """The square chain at 7 gates: its circuit, device CRS and the host
    protocol's unfolded proof for TD and CHAIN_BL."""
    r1cs, wit = synthetic_square_chain(CHAIN_GATES)
    dq = prover.compile_r1cs(r1cs, device="cpu")
    crs = prover.device_setup(dq, trapdoor=TD)
    unfolded = _host_prove(_host_reference(r1cs, dq), wit, CHAIN_BL)
    return dq, crs, wit, ser.proof_to_json(unfolded)


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_device_prove_runs_no_host_scalar_mul(chain, mesh_ranks,
                                              monkeypatch, path):
    dq, crs, wit, unfolded = chain
    if path == "mesh":
        assert mesh_ranks() == [unfolded, unfolded]
        return

    def raise_(*args):
        raise AssertionError("a host scalar multiplication in device_prove")

    monkeypatch.setattr(hc, "g1_scalar_mul", raise_)
    monkeypatch.setattr(hc, "g2_scalar_mul", raise_)
    proof = prover.device_prove(dq, crs, wit, blinding=CHAIN_BL)
    assert ser.proof_to_json(proof) == unfolded
