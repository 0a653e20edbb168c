"""The port's CLI and JSON codecs against the JAX package's, on the CPU.

The port's CLI runs `simple.zk` with `--device cpu` (the plain versions
of the kernels) and the pinned trapdoor of `tests/test_torch_prover.py`:
- `compile` prints the JAX CLI's line, for the lisp-esque and the legacy
  formats; `setup`, `prove` and `verify` exit 0;
- its `.npz` CRS equals, array for array, the one the JAX CLI's device
  flow writes for the same trapdoor;
- the JAX CLI (`--backend device`) accepts the port's proof, and the
  port's CLI accepts the JAX CLI's proof; a wrong `--public` exits 1;
- `--check-witness` on a witness that violates a gate exits 3;
- `proof_to_json` / `witness_to_json` write the JAX codecs' text;
- without a card and without `--device cpu` the CLI exits non-zero;
- `--backend host` setup -> prove -> verify over BN254 and Z251 exits 0,
  0, 0 and 1 on a wrong input, its JSON CRS is the JAX CLI's text for
  the same --trapdoor, and each CLI accepts the other's host proof;
- `bench --backend host` prints one JSON report; `bench` and `--field
  z251` with `--backend device` exit 2.
Tolerance: exact equality.
"""

import json

import numpy as np
import pytest
import torch

from zksnark_tpu import cli as jcli
from zksnark_tpu.field.host import FR as JFR
from zksnark_tpu.frontend import witness as jwitness
from zksnark_tpu.groth16.protocol import Proof as JProof
from zksnark_tpu.utils import serialization as jser
from zksnark_tpu_torch import cli
from zksnark_tpu_torch.field.host import FR
from zksnark_tpu_torch.frontend import witness
from zksnark_tpu_torch.utils import serialization as ser

SIMPLE = "test_programs/simple.zk"
TD = "111,222,333,444,555"
torch.set_num_threads(1)     # small tensors: threads only add overhead

# `y` is assigned a sum, which the compiler skips (no inputs for its
# gate), while the witness evaluates it: the gate reads 0 * 0 = x + 1
BAD_WITNESS = """(in x)
(out y)
(verify y)

(program
    (= y (+ x 1)))"""


def _port(*args):
    return cli.main(list(args) + ["--device", "cpu"])


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    crs, jcrs = str(d / "crs.json"), str(d / "jax_crs.json")
    proof, jproof = str(d / "proof.json"), str(d / "jax_proof.json")
    rc = {
        "setup": _port("setup", SIMPLE, "--crs", crs, "--trapdoor", TD),
        "prove": _port("prove", SIMPLE, "--crs", crs, "--inputs", "3,2,4",
                       "--proof", proof, "--check-witness"),
        "verify": _port("verify", SIMPLE, "--crs", crs, "--proof", proof,
                        "--public", "2,34"),
        "jax_setup": jcli.main(["setup", SIMPLE, "--backend", "device",
                                "--crs", jcrs, "--trapdoor", TD]),
        "jax_verify_port_proof": jcli.main([
            "verify", SIMPLE, "--backend", "device", "--crs", crs,
            "--proof", proof, "--public", "2,34"]),
        "jax_prove": jcli.main(["prove", SIMPLE, "--backend", "device",
                                "--crs", jcrs, "--inputs", "3,2,4",
                                "--proof", jproof]),
    }
    return dict(rc=rc, crs=crs, jcrs=jcrs, proof=proof, jproof=jproof)


@pytest.mark.parametrize("circuit", [SIMPLE, "test_programs/quad_share.zk",
                                     "test_programs/8bit_comparator.zk"])
def test_compile_prints_the_jax_line(circuit, capsys):
    assert _port("compile", circuit) == 0
    mine = capsys.readouterr().out
    assert jcli.main(["compile", circuit]) == 0
    assert mine == capsys.readouterr().out
    assert mine.startswith("wires=")


def test_setup_prove_verify_exit_0(flow):
    assert flow["rc"] == {"setup": 0, "prove": 0, "verify": 0,
                          "jax_setup": 0, "jax_verify_port_proof": 0,
                          "jax_prove": 0}


def test_npz_crs_equals_jax(flow):
    with np.load(flow["crs"] + ".npz") as mine, \
            np.load(flow["jcrs"] + ".npz") as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in mine.files:
            assert mine[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_each_cli_accepts_the_others_proof(flow):
    # the JAX CLI accepted the port's proof in the fixture
    assert flow["rc"]["jax_verify_port_proof"] == 0
    assert _port("verify", SIMPLE, "--crs", flow["jcrs"], "--proof",
                 flow["jproof"], "--public", "2,34") == 0
    assert _port("verify", SIMPLE, "--crs", flow["crs"], "--proof",
                 flow["jproof"], "--public", "2,34") == 0


def test_wrong_public_exits_1(flow, capsys):
    assert _port("verify", SIMPLE, "--crs", flow["crs"], "--proof",
                 flow["proof"], "--public", "2,35") == 1
    assert "REJECT" in capsys.readouterr().out


def test_check_witness_on_a_bad_witness_exits_3(tmp_path, capsys):
    circ = tmp_path / "bad.zk"
    circ.write_text(BAD_WITNESS)
    # the check runs before the CRS is read: none is needed
    assert _port("prove", str(circ), "--crs", str(tmp_path / "none.json"),
                 "--inputs", "5", "--check-witness") == 3
    assert "violates 1 constraint(s) at roots [1]" in capsys.readouterr().out


def test_legacy_format_setup(tmp_path):
    crs = str(tmp_path / "crs.json")
    assert _port("setup", "test_programs/quad_share.zk", "--crs", crs,
                 "--trapdoor", TD) == 0
    sigmag1, _ = ser.host_crs_load(crs + ".npz")
    assert len(sigmag1.sum_gamma) == 3       # unity + 2 verify wires


def test_json_text_equals_jax(flow):
    proof = ser.proof_from_json(open(flow["proof"]).read())
    jp = JProof(a=proof.a, b=proof.b, c=proof.c)
    assert ser.proof_to_json(proof) == jser.proof_to_json(jp) == \
        open(flow["proof"]).read()
    assert ser.proof_from_json(jser.proof_to_json(jp)) == proof
    jtext = open(flow["jproof"]).read()
    assert ser.proof_to_json(ser.proof_from_json(jtext)) == jtext
    code = open(SIMPLE).read()
    w = witness.weights(code, [3, 2, 4], FR)
    assert w == jwitness.weights(code, [3, 2, 4], JFR)
    text = ser.witness_to_json(w)
    assert text == jser.witness_to_json(w)
    assert ser.witness_from_json(text) == jser.witness_from_json(text) == w
    with pytest.raises(ValueError, match="format version 2"):
        ser.witness_from_json('{"version": 2, "weights": []}')


def test_no_card_exits_nonzero(monkeypatch, capsys):
    from zksnark_tpu_torch.examples import keccak_proof

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("compile", "setup"):
        with pytest.raises(SystemExit) as e:
            cli.main([cmd, SIMPLE])
        assert e.value.code not in (0, None)
        assert "no CUDA device" in capsys.readouterr().err
    assert keccak_proof.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


HOST_CASES = {"bn254": ("2,34", "2,35"), "z251": ("2,34", "2,35")}


@pytest.mark.parametrize("field", sorted(HOST_CASES))
def test_host_flow_exit_codes(field, tmp_path, capsys):
    """--backend host: setup -> prove -> verify exit 0, 0, 0 and a wrong
    public input exits 1; the JSON CRS is read back by the JAX codec."""
    crs, proof = str(tmp_path / "crs.json"), str(tmp_path / "proof.json")
    common = ["--backend", "host", "--field", field, "--crs", crs]
    good, bad = HOST_CASES[field]
    assert cli.main(["setup", SIMPLE, "--trapdoor", TD] + common) == 0
    assert cli.main(["prove", SIMPLE, "--inputs", "3,2,4", "--proof", proof,
                     "--check-witness"] + common) == 0
    assert cli.main(["verify", SIMPLE, "--proof", proof, "--public", good]
                    + common) == 0
    assert "ACCEPT" in capsys.readouterr().out
    assert cli.main(["verify", SIMPLE, "--proof", proof, "--public", bad]
                    + common) == 1
    assert "REJECT" in capsys.readouterr().out
    text = open(crs).read()
    assert jser.crs_to_json(*jser.crs_from_json(text)) == text


@pytest.mark.parametrize("field", sorted(HOST_CASES))
def test_host_json_equals_jax_cli(field, tmp_path):
    """The same --trapdoor gives the JAX CLI's CRS text; each CLI accepts
    the other's proof (the host prove draws its own blinding)."""
    mine, theirs = str(tmp_path / "crs.json"), str(tmp_path / "jcrs.json")
    proof, jproof = str(tmp_path / "p.json"), str(tmp_path / "jp.json")
    common = ["--backend", "host", "--field", field]
    assert cli.main(["setup", SIMPLE, "--crs", mine, "--trapdoor", TD]
                    + common) == 0
    assert jcli.main(["setup", SIMPLE, "--crs", theirs, "--trapdoor", TD]
                     + common) == 0
    assert open(mine).read() == open(theirs).read()
    assert cli.main(["prove", SIMPLE, "--crs", mine, "--inputs", "3,2,4",
                     "--proof", proof] + common) == 0
    assert jcli.main(["prove", SIMPLE, "--crs", theirs, "--inputs",
                      "3,2,4", "--proof", jproof] + common) == 0
    good = HOST_CASES[field][0]
    assert jcli.main(["verify", SIMPLE, "--crs", theirs, "--proof", proof,
                      "--public", good] + common) == 0
    assert cli.main(["verify", SIMPLE, "--crs", mine, "--proof", jproof,
                     "--public", good] + common) == 0


def test_bench_host_prints_a_report(capsys):
    assert cli.main(["bench", SIMPLE, "--backend", "host", "--field", "z251",
                     "--trapdoor", TD, "--inputs", "3,2,4",
                     "--public", "2,34"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert set(report["phases_s"]) == {"setup", "prove", "verify"}
    assert out.strip().endswith("verify: ACCEPT")


def test_bench_device_exits_2(capsys):
    assert _port("bench", SIMPLE) == 2
    assert "--backend host" in capsys.readouterr().err


def test_device_z251_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        _port("setup", SIMPLE, "--field", "z251")
    assert e.value.code == 2
    assert "--backend device requires --field bn254" in \
        capsys.readouterr().err
