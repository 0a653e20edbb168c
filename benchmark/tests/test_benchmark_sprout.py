"""The Sprout path's plain reference (`reference/sprout_path.py`) against
`hashlib` and against the port's R1CS, on the CPU at depths 1 and 2; a
proof of a path with one sibling bit flipped, and the control, come out
not correct."""

import hashlib
import os
import random
import struct
import subprocess
import sys

import numpy as np
import pytest

from benchmark import control, session
from benchmark.metrics import wide_rows_roofline
from benchmark.reference import groth16
from benchmark.reference import sprout_path as rs

R = groth16.R
SEED = 2 ** 31 + 4099


def _pad(msg: bytes) -> bytes:
    return (msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64)
            + struct.pack(">Q", 8 * len(msg)))


@pytest.mark.parametrize("msg", [b"abc", b"", bytes(range(55))])
def test_plain_compress_against_hashlib(msg):
    words = rs.sha256_compress(rs.IV, _pad(msg))
    got = b"".join(x.to_bytes(4, "big") for x in words)
    assert got == hashlib.sha256(msg).digest()
    if msg == b"abc":
        assert got.hex() == ("ba7816bf8f01cfea414140de5dae2223"
                             "b00361a396177a9cb410ff61f20015ad")


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json; import benchmark.reference.sprout_path, "
            "benchmark.metrics.wide_rows_roofline; print(json.dumps("
            "sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=session.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (session.FORBIDDEN | {"zksnark_tpu_torch", "torch"})


@pytest.fixture(scope="module", params=[1, 2])
def path(request):
    from benchmark.circuits.sprout_path import Circuit, statement

    cfg = {"depth": request.param}
    port = Circuit(cfg)
    return cfg, rs.Reference(cfg), port, port.r1cs(), statement


def _sums_of(r1, wit, lag):
    """The sums at x of the port's R1CS and a witness, wire by wire."""
    index = {r: i for i, r in enumerate(r1.roots)}
    lg = [lag.at(i) for i in range(r1.num_gates)]

    def col(rows, hi):
        return sum(wit[i] * v * lg[index[r]] for i in range(hi)
                   for r, v in rows[i]) % R

    full, pub = r1.num_wires, r1.input + 1
    return groth16.Sums(col(r1.u, full), col(r1.v, full), col(r1.w, full),
                        col(r1.u, pub), col(r1.v, pub), col(r1.w, pub))


def test_reference_equals_the_ports_r1cs(path):
    cfg, ref, port, r1, statement = path
    assert (ref.n_gates, ref.num_wires, ref.public) == (
        r1.num_gates, r1.num_wires, r1.input)
    assert ref.nnz == sum(len(p) for rows in (r1.u, r1.v, r1.w)
                          for p in rows)
    for hist, rows in zip(ref.widths, (r1.u, r1.v, r1.w)):
        per_gate = np.bincount([root - 1 for pts in rows for root, _ in pts],
                               minlength=r1.num_gates)
        assert dict(hist) == {k: int(c) for k, c in
                              enumerate(np.bincount(per_gate)) if c}
    st = statement(cfg, random.Random(cfg["depth"]))
    lag = groth16.Lagrange(31415926535897932384626, ref.n_gates)
    sums, errors = ref.sums(st, lag)
    assert errors == 0
    assert sums == _sums_of(r1, port.witness(st), lag)


@pytest.mark.parametrize("launch_slots", [None, 1 << 40])
def test_layout_rule_is_the_programs(path, launch_slots, monkeypatch):
    """The metric counts, from the reference's widths and the program's
    k0, the wide rows and non-zeros that `compile_r1cs` lays out: at the
    program's own rule (the multipack's and the adders' rows leave the
    ELL) and with a wide launch too dear for any row to leave it."""
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.utils import profiling

    _, ref, _, r1, _ = path
    if launch_slots is not None:
        monkeypatch.setattr(prover, "WIDE_LAUNCH_SLOTS", launch_slots)
    prover.compile_r1cs(r1, device="cpu")
    counts = profiling.layout_counts()
    k0s = wide_rows_roofline.narrow_widths()
    assert k0s == [counts[f"narrow_width_{m}"] for m in "uvw"]
    nz, rows = counts["wide_nonzeros"], counts["wide_rows"]
    assert (nz == 0) == (launch_slots is not None)
    assert wide_rows_roofline.least(ref, k0s) == (
        nz, nz * (4 + 2 * 32) + rows * 32)


def test_nothing_to_read_without_layout_counters(monkeypatch):
    """A program without the layout counters (the parent of the split
    layout) leaves the metric nothing to read, and nothing raises."""
    from zksnark_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "layout_counts")
    assert wide_rows_roofline.narrow_widths() is None

    class Run:
        extra: dict = {}
        trace_data = None

        def reference(self):
            return rs.Reference({"depth": 1})

    run = Run()
    wide_rows_roofline.collect(run)
    assert run.extra == {}
    assert wide_rows_roofline.read(run) is None


def test_flipped_sibling_bit_is_wrong(path):
    """Proofs of the witness of a path whose first sibling has one bit
    flipped (another root) against the statement's: every one wrong; the
    true witness's proofs all right."""
    cfg, ref, port, r1, statement = path
    st = statement(cfg, random.Random(SEED))
    leaf, pos, sibs = st
    bad_sib = bytes([sibs[0][0] ^ 0x10]) + sibs[0][1:]
    bad = (leaf, pos, [bad_sib] + list(sibs[1:]))
    trapdoor = (11, 22, 33, 44, 5555555)
    lag = groth16.Lagrange(trapdoor[4], ref.n_gates)
    req = control.generator.Request(0, 0, st, (7, 9))
    for witness_of, wrong in ((st, 0), (bad, 1)):
        sums = _sums_of(r1, port.witness(witness_of), lag)
        pf = control.Proof(*groth16.proof(sums, trapdoor, req.blinding))
        checks = session.judge(SEED, trapdoor,
                               [session.Record(req, 0.0, pf)], ref)
        assert checks["proofs_wrong"][0] == wrong
        assert session.passed(checks) == (not wrong)


def test_control_is_not_correct():
    cell = session.find_cell(session.load_spec(), "sprout_path-d29.prove")
    cell = cell._replace(config=dict(cell.config, depth=1))
    ref = session.reference_for(cell.config)
    trapdoor, records = control.control_records(cell, SEED, 2, ref)
    checks = session.judge(SEED, trapdoor, records, ref)
    assert not session.passed(checks)
    assert checks["proofs_wrong"][0] == 2
