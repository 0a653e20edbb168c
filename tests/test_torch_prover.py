"""The port's device prover against the JAX package, end to end on
simple.zk under a pinned trapdoor and blinding (TD / BL of
tests/test_device_prover.py), on the CPU (every kernel replaced by its
plain version).

- port `device_setup` equals JAX `device_setup` element for element;
- port `device_prove` equals JAX `device_prove` and host `protocol.prove`,
  and verify accepts [2, 34] and rejects [2, 35];
- a JAX CRS carried over by `crs_from_jax_arrays` and through the JAX
  `.npz` checkpoint is the port's own CRS limb for limb, so it proves the
  same proof;
- a port-saved `.npz` loads in `zksnark_tpu.utils.serialization.
  device_crs_load` as the JAX package's own CRS, array for array, and
  proves there.
The JAX package proves once, from the port-saved CRS it loaded: that CRS
is its own array for array (checked), and `device_prove` is a function of
its inputs, so the one proof stands for both.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from zksnark_tpu.field.host import FR  # noqa: E402
from zksnark_tpu.frontend import compiler, witness  # noqa: E402
from zksnark_tpu.groth16 import prover as jprover  # noqa: E402
from zksnark_tpu.utils import serialization as jser  # noqa: E402
from zksnark_tpu_torch.field.limb import limbs_to_jax_np  # noqa: E402
from zksnark_tpu_torch.frontend.r1cs import R1CS  # noqa: E402
from zksnark_tpu_torch.groth16 import protocol, prover  # noqa: E402
from zksnark_tpu_torch.groth16.backend import BN254Backend  # noqa: E402
from zksnark_tpu_torch.utils import serialization as ser  # noqa: E402

TD = (111, 222, 333, 444, 555)
BL = (666, 777)
torch.set_num_threads(1)     # small tensors: threads only add overhead


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    code = open("test_programs/simple.zk").read()
    r1cs = compiler.parse(code, FR)
    w = witness.weights(code, [3, 2, 4], FR)
    jq = jprover.compile_r1cs(r1cs)
    jcrs = jprover.device_setup(jq, trapdoor=TD)
    port_r1cs = R1CS(u=r1cs.u, v=r1cs.v, w=r1cs.w, roots=r1cs.roots,
                     input=r1cs.input)
    dq = prover.compile_r1cs(port_r1cs, device="cpu")
    crs = prover.device_setup(dq, trapdoor=TD)
    proof = prover.device_prove(dq, crs, w, blinding=BL)
    # the port's CRS through the JAX .npz checkpoint into the JAX package,
    # which proves from it
    path = str(tmp_path_factory.mktemp("crs") / "port_crs.npz")
    ser.device_crs_save(path, crs)
    jcrs_port = jser.device_crs_load(path)
    jproof = jprover.device_prove(jq, jcrs_port, w, blinding=BL)
    return dict(w=w, jq=jq, jcrs=jcrs, jcrs_port=jcrs_port, jproof=jproof,
                dq=dq, crs=crs, proof=proof)


def _proof_tuple(p):
    return (p.a, p.b, p.c)


def _jax_points(jp):
    return tuple(np.asarray(c) for c in jp)


def _assert_crs_equal(crs, jcrs):
    """Port limbs re-chunked to JAX digits equal the JAX arrays (Z is
    stored as uint8 digits on the JAX side)."""
    for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2"):
        mine, theirs = getattr(crs, name), getattr(jcrs, name)
        for m, t in zip(mine, theirs):
            np.testing.assert_array_equal(
                limbs_to_jax_np(m.numpy()), np.asarray(t).astype(np.float32),
                err_msg=name)
    for f in ("alpha", "beta", "delta", "sum_gamma"):
        assert getattr(crs.sigmag1, f) == getattr(jcrs.sigmag1, f)
    for f in ("beta", "gamma", "delta"):
        assert getattr(crs.sigmag2, f) == getattr(jcrs.sigmag2, f)


def test_device_setup_equals_jax(both):
    _assert_crs_equal(both["crs"], both["jcrs"])


def test_device_prove_equals_jax_and_host(both):
    from zksnark_tpu.groth16 import protocol as jprotocol
    from zksnark_tpu.groth16.backend import BN254Backend as JBackend
    from zksnark_tpu.groth16.qap import from_r1cs
    from zksnark_tpu.frontend.r1cs import R1CS as JR1CS

    proof = both["proof"]
    assert _proof_tuple(proof) == _proof_tuple(both["jproof"])
    # the host protocol over the same domain (tests/test_device_prover.py)
    code = open("test_programs/simple.zk").read()
    r1cs = compiler.parse(code, FR)
    roots = prover.domain_roots(both["dq"].domain)
    host_r1cs = JR1CS(
        u=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.u],
        v=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.v],
        w=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.w],
        roots=roots, input=r1cs.input)
    jbe = JBackend()
    qap = from_r1cs(FR, host_r1cs)
    crs_host = jprotocol.setup(jbe, qap, trapdoor=TD)
    host = jprotocol.prove(jbe, qap, crs_host, both["w"], blinding=BL)
    assert _proof_tuple(proof) == _proof_tuple(host)

    be = BN254Backend()
    crs = (both["crs"].sigmag1, both["crs"].sigmag2)
    assert protocol.verify(be, crs, [2, 34], proof)
    assert not protocol.verify(be, crs, [2, 35], proof)
    assert protocol.verify_fast(be, crs, [2, 34], proof)
    assert not protocol.verify_fast(be, crs, [2, 35], proof)


def _assert_same_points(a, b):
    for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert torch.equal(x, y), name


def test_crs_carried_from_jax_is_the_port_crs(both):
    """The carried CRS is the port's own CRS limb for limb, so it proves
    exactly the proof above (device_prove is a function of its inputs)."""
    jcrs = both["jcrs"]
    carried = ser.crs_from_jax_arrays(
        *(_jax_points(getattr(jcrs, n)) for n in
          ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2")),
        jcrs.sigmag1, jcrs.sigmag2, device="cpu")
    _assert_crs_equal(carried, jcrs)
    _assert_same_points(carried, both["crs"])
    assert carried.sigmag1 == both["crs"].sigmag1
    assert carried.sigmag2 == both["crs"].sigmag2


def test_jax_npz_loads_in_port(both, tmp_path):
    path = str(tmp_path / "jax_crs.npz")
    jser.device_crs_save(path, both["jcrs"])
    loaded = ser.device_crs_load(path, device="cpu")
    _assert_crs_equal(loaded, both["jcrs"])
    _assert_same_points(loaded, both["crs"])


def test_port_npz_loads_in_jax_and_proves(both):
    """The JAX package loads the port-saved .npz as its own CRS (the same
    arrays, dtypes and host parts) and proves the port's proof from it."""
    loaded, own = both["jcrs_port"], both["jcrs"]
    for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2"):
        for a, b in zip(getattr(loaded, name), getattr(own, name)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for f in ("alpha", "beta", "delta", "sum_gamma"):
        assert getattr(loaded.sigmag1, f) == getattr(own.sigmag1, f)
    for f in ("beta", "gamma", "delta"):
        assert getattr(loaded.sigmag2, f) == getattr(own.sigmag2, f)
    assert _proof_tuple(both["jproof"]) == _proof_tuple(both["proof"])


def test_port_npz_roundtrip(both, tmp_path):
    path = str(tmp_path / "port_crs.npz")
    ser.device_crs_save(path, both["crs"])
    again = ser.device_crs_load(path, device="cpu")
    for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2"):
        for a, b in zip(getattr(again, name), getattr(both["crs"], name)):
            assert torch.equal(a, b)
    assert again.sigmag1 == both["crs"].sigmag1
    assert again.sigmag2 == both["crs"].sigmag2
