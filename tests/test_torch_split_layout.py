"""The constraint matrices' layout split by row width
(`zksnark_tpu_torch/groth16/prover.py`: `compile_r1cs`, `EllMatrix`,
`WideRows`), on the CPU (the wide rows' kernel replaced by its plain
version, `ops.montmul.wide_rows_plain`).

- On random R1CS with row widths 0-300, every matrix's weighted
  evaluations equal the dense host product, whatever the ELL width; a
  subset of rows (`take_rows`, the mesh's gate sharding) equals those
  rows; setup's per-wire sums equal the unsplit layout's.
- The square chain's layout and that of the Keccak circuit's gates are
  the padded ELL they had (kept here as `_padded_ell`), with no wide
  rows, and the layout counters add up.
- A small general R1CS (a packed adder, empty C, a multipacked output),
  its wide rows on the CSR path, proves on the CPU to the host
  `protocol.prove`'s proof bit for bit, which verifies; on a mesh of two
  gloo ranks (subprocesses started at the module's start) it proves the
  same proof.
Tolerance: exact equality.
"""

import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from zksnark_tpu_torch.bench import synthetic_square_chain
from zksnark_tpu_torch.builder.circuit import Circuit
from zksnark_tpu_torch.builder.instance import CircuitInstance
from zksnark_tpu_torch.field.host import FR
from zksnark_tpu_torch.field.limb import FR_CTX
from zksnark_tpu_torch.frontend.r1cs import R1CS
from zksnark_tpu_torch.groth16 import protocol, prover
from zksnark_tpu_torch.groth16.backend import BN254Backend
from zksnark_tpu_torch.groth16.qap import from_r1cs
from zksnark_tpu_torch.utils import profiling
from zksnark_tpu_torch.utils import serialization as ser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = FR.p
TD = (1234, 5678, 9101, 1121, 3141)
BLIND = (98765, 43210)
torch.set_num_threads(1)

ADDER = r'''
def adder():
    """Packed 3-bit words a + b + 5 by lastbits_add, checked bits (empty
    C), the sum multipacked 2 bits at a time; (r1cs, witness)."""
    from zksnark_tpu_torch.builder.circuit import Circuit
    from zksnark_tpu_torch.builder.instance import CircuitInstance
    from zksnark_tpu_torch.field.host import FR

    c = Circuit(FR)
    a = [c.new_wire() for _ in range(3)]
    b = [c.new_wire() for _ in range(3)]
    for bit in a + b:
        c.enforce_bit(bit)
    total = c.lastbits_add([(1, c.pack(a)), (1, c.pack(b))], 5, 3, 2)
    inst = CircuitInstance(c, c.multipack(total, chunk=2), a + b,
                           lambda sc: FR.from_int(sc + 1))
    return inst.r1cs(), inst.weights([1, 1, 0, 0, 1, 1])
'''
exec(ADDER)

# one mesh rank: python -c RANK PORT RANK OUT
RANK = r"""
import sys
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from zksnark_tpu_torch.groth16 import prover
from zksnark_tpu_torch.parallel import multihost
from zksnark_tpu_torch.utils import serialization as ser
%(adder)s
prover.WIDE_LAUNCH_SLOTS = 0
port, rank = map(int, sys.argv[1:3])
multihost.init_distributed(f"tcp://127.0.0.1:{port}", 2, rank,
                           device="cpu")
mesh = multihost.global_mesh()
r1cs, wit = adder()
dqap = prover.compile_r1cs(r1cs, device="cpu")
assert dqap.wide_nonzeros > 0
crs = prover.device_setup(dqap, trapdoor=%(trapdoor)r, mesh=mesh)
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
    prog = RANK % {"root": ROOT, "adder": ADDER, "trapdoor": TD,
                   "blinding": BLIND}
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


def _padded_ell(rows, root_index, n):
    """The layout before the split: every gate padded to the widest
    (wire indices, values as ints)."""
    per_gate = [[] for _ in range(n)]
    for wire, points in enumerate(rows):
        for root, value in points:
            per_gate[root_index[root]].append((wire, value))
    k = max(1, max((len(g) for g in per_gate), default=1))
    idx = np.zeros((n, k), dtype=np.int64)
    vals = np.zeros((n, k), dtype=object)
    for g, entries in enumerate(per_gate):
        for j, (wire, value) in enumerate(entries):
            idx[g, j] = wire
            vals[g, j] = value
    return idx, FR_CTX.to_mont_np(vals)


def _random_r1cs(seed, n_gates=120, n_wires=90):
    rng = random.Random(seed)
    rows = [[[] for _ in range(n_wires)] for _ in range(3)]
    for g in range(n_gates):
        for m in rows:
            k = (rng.choice([1, 2, 3, 40, 300]) if g % 9 == 0
                 else rng.choice([0, 1, 2]))
            for _ in range(k):
                m[rng.randrange(n_wires)].append((g + 1, rng.randrange(P)))
    return R1CS(u=rows[0], v=rows[1], w=rows[2],
                roots=list(range(1, n_gates + 1)), input=3)


def _dense_evals(r1cs, wit, n):
    mats = r1cs.dense_point_matrices()
    return [[sum(int(m[i, g]) * wit[i] for i in range(r1cs.num_wires)) % P
             for g in range(r1cs.num_gates)] + [0] * (n - r1cs.num_gates)
            for m in mats]


@pytest.mark.parametrize("seed,launch", [(1, 0), (2, 64), (3, 1 << 30)])
def test_split_layout_against_dense_product(seed, launch, monkeypatch):
    monkeypatch.setattr(prover, "WIDE_LAUNCH_SLOTS", launch)
    r1cs = _random_r1cs(seed)
    dq = prover.compile_r1cs(r1cs, device="cpu")
    mats = (dq.u, dq.v, dq.w)
    if launch:
        assert all((m.wide is None) == (launch > dq.n) for m in mats)
    else:
        assert all(m.wide is not None and m.idx.shape[1] <= 2
                   for m in mats)
    rng = random.Random(seed)
    wit = [rng.randrange(P) for _ in range(r1cs.num_wires)]
    wm = torch.from_numpy(FR_CTX.to_mont_np(wit))
    rows = torch.from_numpy(np.random.default_rng(seed).permutation(
        dq.n)[:50])
    for m, want in zip(mats, _dense_evals(r1cs, wit, dq.n)):
        got = prover._weighted_evals(m, wm)
        assert list(FR_CTX.from_mont_np(got.numpy())) == want
        assert torch.equal(prover._weighted_evals(m.take_rows(rows), wm),
                           got[rows])


def test_setup_sums_equal_the_unsplit_layout(monkeypatch):
    r1cs = _random_r1cs(4)
    got = []
    for launch in (0, 1 << 30):
        monkeypatch.setattr(prover, "WIDE_LAUNCH_SLOTS", launch)
        dq = prover.compile_r1cs(r1cs, device="cpu")
        xi = torch.from_numpy(FR_CTX.to_mont_np(
            [pow(777, i, P) for i in range(dq.n)]))
        c = [torch.from_numpy(FR_CTX.to_mont_np([v]))[0]
             for v in (3, 5, 7, 11)]
        got.append(prover._setup_scalars(
            dq.domain, dq.num_wires, (dq.u, dq.v, dq.w), xi, *c))
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_narrow_width_rule():
    n = 1 << 10
    assert prover.narrow_width(n, np.bincount([0] * n)) == 1
    assert prover.narrow_width(n, np.bincount([1] * (n - 1) + [2])) == 2
    # a few wide rows leave the ELL once they outweigh a launch
    widths = np.bincount([2] * (n - 4) + [300] * 4)
    assert prover.narrow_width(n, widths) == 300
    assert prover.narrow_width(1 << 20, np.bincount(
        [2] * ((1 << 20) - 4) + [300] * 4)) == 2
    assert prover._wide_group(4) == 1 and prover._wide_group(35) == 8
    assert prover._wide_group(253) == 32


def _keccak_r1cs():
    """The Keccak circuit's gates (`Circuit.keccakf_1600`'s xor, not and
    and, the xor with constant bits, public bit checkers), on two words:
    its rows' widths at a small size."""
    c = Circuit(FR)
    x, y = c.new_word64(), c.new_word64()
    t = c.u64_bitwise_op(x, y, Circuit.new_xor)
    n = c.u64_unary_op(t, Circuit.new_not)
    a = c.u64_bitwise_op(n, y, Circuit.new_and)
    out = c.u64_bitwise_op(a, c.const_word64(0x8000000080008081),
                           Circuit.new_xor)
    ins = [b for byte in x + y for b in byte]
    inst = CircuitInstance(c, [b for byte in out for b in byte]
                           + c.bit_check(ins), ins,
                           lambda sc: FR.from_int(sc + 1))
    return inst.r1cs()


@pytest.mark.parametrize("shape", ["square_chain", "keccak"])
def test_existing_shapes_keep_the_padded_ell(shape):
    r1cs = (synthetic_square_chain(100)[0] if shape == "square_chain"
            else _keccak_r1cs())
    dq = prover.compile_r1cs(r1cs, device="cpu")
    root_index = {r: i for i, r in enumerate(r1cs.roots)}
    counts = profiling.layout_counts()
    nnz = sum(len(p) for rows in (r1cs.u, r1cs.v, r1cs.w) for p in rows)
    for name, m, rows in zip("uvw", (dq.u, dq.v, dq.w),
                             (r1cs.u, r1cs.v, r1cs.w)):
        idx, val = _padded_ell(rows, root_index, dq.n)
        assert m.wide is None
        assert m.idx.dtype == torch.int64 and m.val.dtype == torch.int32
        assert np.array_equal(m.idx.numpy(), idx)
        assert np.array_equal(m.val.numpy(), val)
        assert counts[f"narrow_width_{name}"] == idx.shape[1]
    assert counts["wide_rows"] == counts["wide_nonzeros"] == 0
    assert counts["narrow_rows"] == 3 * dq.n
    assert counts["product_slots"] == dq.n * sum(
        m.idx.shape[1] for m in (dq.u, dq.v, dq.w))
    assert counts["padded_slots"] == counts["product_slots"] - nnz


@pytest.fixture(scope="module")
def adder_proof():
    r1cs, wit = adder()
    saved = prover.WIDE_LAUNCH_SLOTS
    prover.WIDE_LAUNCH_SLOTS = 0
    try:
        dq = prover.compile_r1cs(r1cs, device="cpu")
    finally:
        prover.WIDE_LAUNCH_SLOTS = saved
    counts = profiling.layout_counts()
    crs = prover.device_setup(dq, trapdoor=TD)
    profiling.clear_spans()
    with profiling.tracing():
        proof = prover.device_prove(dq, crs, wit, blinding=BLIND)
    issue = [s for s in profiling.spans() if s.name == "prove.issue"]
    profiling.clear_spans()
    return r1cs, wit, dq, crs, proof, counts, issue


def test_general_r1cs_proof_equals_host_and_verifies(adder_proof):
    r1cs, wit, dq, crs, proof, counts, issue = adder_proof
    assert dq.v.wide is not None and counts["wide_nonzeros"] > 0
    assert counts["wide_nonzeros"] == dq.wide_nonzeros == sum(
        m.wide.nnz for m in (dq.u, dq.v, dq.w) if m.wide is not None)
    assert [s.attrs for s in issue] == [{"wide_nonzeros": dq.wide_nonzeros,
                                         "msm_tables": 5}]
    assert any(not pts for pts in r1cs.w) and r1cs.check_satisfied(
        wit, P) == []
    roots = prover.domain_roots(dq.domain)
    host = R1CS(*([[(roots[ri - 1], v) for ri, v in row] for row in m]
                  for m in (r1cs.u, r1cs.v, r1cs.w)),
                roots=roots, input=r1cs.input)
    be = BN254Backend()
    qap = from_r1cs(FR, host)
    want = protocol.prove(be, qap, protocol.setup(be, qap, trapdoor=TD),
                          wit, blinding=BLIND)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
    pair = (crs.sigmag1, crs.sigmag2)
    assert protocol.verify_fast(be, pair, wit[1:3], proof)
    assert not protocol.verify_fast(be, pair, [wit[1], wit[2] + 1], proof)


def test_mesh_proof_equals_single_device(adder_proof, mesh_ranks):
    proof = adder_proof[4]
    for text in mesh_ranks():
        assert text == ser.proof_to_json(proof)


def test_stream_marks_close_intervals():
    """`StreamMarks.close` makes one span an interval between two marks,
    overlapping ones included (`evals` inside `quotient`)."""
    class Ev:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

    profiling.clear_spans()
    with profiling.tracing(), profiling.span("prove") as root:
        marks = profiling.StreamMarks("cuda", root)
        marks.events = [Ev(t) for t in (5.0, 6.5, 9.0, 20.0)]
        marks.close((("quotient", 0, 2), ("msm", 2, 3), ("evals", 0, 1)))
    got = {s.name: (s.start_ns, s.end_ns, s.clock, s.prove)
           for s in profiling.spans() if s.clock == "stream"}
    profiling.clear_spans()
    assert got == {"quotient": (0, 4_000_000, "stream", root.id),
                   "msm": (4_000_000, 15_000_000, "stream", root.id),
                   "evals": (0, 1_500_000, "stream", root.id)}
