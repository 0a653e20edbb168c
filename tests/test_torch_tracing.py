"""The port's span recorder around `device_prove` and its launch registry
(`zksnark_tpu_torch/utils/profiling.py`), on the CPU at 7 gates.

The device pipeline (`prover._prove_core`: the quotient and the five
MSMs, ~10 s a prove in the CPU's plain versions) is stood in for by
fixed points, and the CRS by small multiples of the generators, so that
these tests stay small; the spans, the witness's codec and upload, its
Montgomery form, the CRS's prove sets and the host assembly run as they
are.  The benchmark's
tests prove through the whole pipeline with the recorder on
(`benchmark/tests/test_benchmark_spans.py`).
"""

import dataclasses
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from zksnark_tpu_torch.field import witness_codec

from zksnark_tpu_torch.bench import synthetic_square_chain
from zksnark_tpu_torch.curve import bn254 as hc
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
from zksnark_tpu_torch.groth16 import prover
from zksnark_tpu_torch.groth16.protocol import SigmaG1, SigmaG2
from zksnark_tpu_torch.ops import curve_kernels, montmul, ntt
from zksnark_tpu_torch.utils import profiling

STAGES = ["prove.encode", "prove.issue", "prove.wait", "prove.assemble"]


def _point(ops, pt):
    return prover.JPoint(*(a[0] for a in prover._host_points_to_jac(
        ops, [pt], "cpu")))


def _small_crs(dq):
    """A CRS of small multiples of the generators, shaped as
    `device_setup`'s for `dq`."""
    g1 = [hc.g1_scalar_mul(hc.G1_GEN_PT, k) for k in range(2, 2 + dq.n)]
    g2 = [hc.g2_scalar_mul(hc.G2_GEN, k) for k in range(3, 3 + dq.n)]
    n_delta = dq.num_wires - dq.input - 1

    def pts(ops, host):
        return prover._host_points_to_jac(ops, host, "cpu")

    return prover.DeviceCRS(
        xi_g1=pts(FQ_OPS, g1), xi_t_g1=pts(FQ_OPS, g1[1:]),
        sum_delta_g1=pts(FQ_OPS, (g1 * 2)[:n_delta]),
        xi_g2=pts(FQ2_OPS, g2),
        sigmag1=SigmaG1(alpha=g1[0], beta=g1[1], delta=g1[2], xi=None,
                        sum_gamma=[], sum_delta=None, xi_t=None),
        sigmag2=SigmaG2(beta=g2[0], gamma=g2[1], delta=g2[2], xi=None))


@pytest.fixture(scope="module")
def circuit():
    r1cs, wit = synthetic_square_chain(7)
    dq = prover.compile_r1cs(r1cs, device="cpu")
    g1 = [hc.g1_scalar_mul(hc.G1_GEN_PT, k) for k in (2, 7, 11, 13)]
    g2 = hc.g2_scalar_mul(hc.G2_GEN, 17)
    core = (_point(FQ_OPS, g1[1]), _point(FQ_OPS, g1[2]),
            _point(FQ2_OPS, g2), _point(FQ_OPS, g1[3]),
            _point(FQ_OPS, g1[0]))
    return dq, _small_crs(dq), wit, core


@pytest.fixture
def prove(circuit, monkeypatch):
    """device_prove at 7 gates with the stood-in device pipeline; `hold`,
    where given, is called inside it (in `prove.issue`); `seen` gathers
    the Montgomery-form witness each prove handed it."""
    dq, crs, wit, core = circuit
    hold, seen = [], []

    def fake_core(domain, n_input, window_bits, ells, sets, weights_mont,
                  blind, marks=None):
        assert marks is None            # no marks on the CPU
        assert sets is crs.sets
        seen.append(weights_mont)
        for h in hold:
            h()
        # the blinding reaches the proof through the MSMs: here, an odd r
        # negates A
        if int(blind[2, 0]) & 1:
            return (prover.jac.neg(FQ_OPS, core[0]),) + core[1:]
        return core

    monkeypatch.setattr(prover, "_prove_core", fake_core)

    def run(blinding=(7, 9)):
        return prover.device_prove(dq, crs, wit, blinding=blinding)

    run.hold, run.seen = hold, seen
    return run


@pytest.fixture(autouse=True)
def _no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _tree(spans, root):
    return [s for s in spans if s.prove == root.id and s is not root]


def test_one_prove_one_tree(prove, circuit):
    plain = prove()
    assert profiling.spans() == []
    with profiling.tracing():
        traced = prove()
    assert traced == plain
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "prove"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.prove == root.id and root.ok
    kids = sorted(_tree(spans, root), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == STAGES
    assert len(spans) == 5
    assert kids[0].attrs == {"wires": circuit[0].num_wires,
                             "codec": "native", "reduced_wires": 0}
    t = root.start_ns
    for s in kids:
        assert s.parent == root.id and s.clock == "epoch" and s.ok
        assert t <= s.start_ns <= s.end_ns <= root.end_ns
        t = s.end_ns


def test_encode_names_its_codec(prove, circuit, monkeypatch):
    """`prove.encode` says which witness codec ran and how many weights it
    reduced with Python's `%`; the native codec's proof, and the witness
    it hands the device pipeline, are the Python codec's."""
    codecs = {}
    for codec in ("native", "python"):
        if codec == "python":
            monkeypatch.setattr(witness_codec, "_load", lambda: None)
        profiling.clear_spans()
        with profiling.tracing():
            proof = prove()
        (enc,) = [s for s in profiling.spans() if s.name == "prove.encode"]
        codecs[codec] = proof, enc.attrs
    wit = circuit[2]
    assert codecs["native"][1]["codec"] == "native"
    assert codecs["native"][1]["reduced_wires"] == 0
    assert codecs["python"][1]["codec"] == "python"
    assert codecs["python"][1]["reduced_wires"] == len(wit)
    assert codecs["native"][0] == codecs["python"][0]
    native, python = prove.seen
    assert native.shape == (circuit[0].num_wires, 8)
    assert torch.equal(native, python)


def test_nothing_recorded_when_off(prove):
    prove()
    assert not profiling.recording()
    with profiling.span("prove"):
        with profiling.span("prove.encode"):
            assert not profiling.recording()
            assert profiling.stream_marks(torch.device("cpu")) is None
    assert profiling.spans() == []


def test_exception_marks_the_span(prove):
    def fail():
        raise RuntimeError("stop")

    prove.hold.append(fail)
    with profiling.tracing(), pytest.raises(RuntimeError):
        prove()
    got = {s.name: s.ok for s in profiling.spans()}
    assert got == {"prove.encode": True, "prove.issue": False,
                   "prove": False}


def _names(prof):
    return sorted(ev.name() for ev in prof.profiler.kineto_results.events())


def _profiled(prove):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            proof = prove()
    return prof, proof


def test_profiler_turns_the_recorder_on(prove, monkeypatch):
    prove()                                # caches filled outside
    prof, proof = _profiled(prove)
    roots = [s for s in profiling.spans() if s.name == "prove"]
    assert len(roots) == 1 and len(profiling.spans()) == 5
    root = roots[0]
    outer = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == "outer"]
    assert len(outer) == 1
    o0 = outer[0].start_ns()
    o1 = o0 + outer[0].duration_ns()
    ms = 1_000_000
    assert o0 - ms <= root.start_ns and root.end_ns <= o1 + ms
    assert root.end_ns - root.start_ns <= o1 - o0 + ms
    # the program's spans add no profiler event
    profiling.clear_spans()
    monkeypatch.setattr(profiling, "_profiler_on", lambda: False)
    prof_off, proof_off = _profiled(prove)
    assert profiling.spans() == []
    assert proof_off == proof
    assert _names(prof_off) == _names(prof)


def test_threads_keep_separate_trees(prove):
    both = threading.Barrier(2, timeout=30)
    prove.hold.append(both.wait)
    out = {}

    def client(k):
        out[k] = prove(blinding=(7 + k, 9))

    with profiling.tracing():
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "prove"]
    assert len(roots) == 2 and len(spans) == 10 and out[0] != out[1]
    issues = []
    for root in roots:
        kids = sorted(_tree(spans, root), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == STAGES
        assert all(s.parent == root.id for s in kids)
        issues.append(kids[1])
    a, b = issues                          # both held at the barrier at once
    assert a.start_ns < b.end_ns and b.start_ns < a.end_ns


def test_stress_many_threads_one_recorder():
    """More threads than cores opening trees at once, switching often:
    every span lands once, in its own thread's tree."""
    trees, threads_n = 100, 16
    saved = sys.getswitchinterval()
    errors = []

    def worker(k):
        try:
            for _ in range(trees):
                with profiling.span("prove", thread=k):
                    for name in STAGES:
                        with profiling.span(name, thread=k):
                            pass
        except Exception as e:             # reported by the assert below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing():
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = profiling.spans()
    assert len(spans) == threads_n * trees * 5
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "prove"]
    assert len(roots) == threads_n * trees
    for s in spans:
        if s.name != "prove":
            root = by_id[s.parent]
            assert root.name == "prove" and s.prove == root.id
            assert s.attrs == root.attrs
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


def test_phase_timer_spans():
    t = profiling.PhaseTimer()
    with profiling.tracing():
        with t.phase("sigma (host)"):
            pass
    (s,) = profiling.spans()
    assert s.name == "sigma (host)" and s.parent is None and s.prove is None
    assert set(t.phases) == {"sigma (host)"}


def test_launch_registry():
    reg = profiling.launch_counters()
    for mod in (montmul, ntt, curve_kernels):
        assert reg[mod.__name__] is mod.LAUNCHES
    total = profiling.launch_counts()
    want = {}
    for counter in reg.values():
        for k, v in counter.items():
            want[k] = want.get(k, 0) + v
    assert total == want
    keys = [k for mod in (montmul, ntt, curve_kernels) for k in mod.LAUNCHES]
    assert len(keys) == len(set(keys)) and set(keys) <= set(total)
    saved = dict(ntt.LAUNCHES)
    try:
        ntt.LAUNCHES["ntt_fr"] += 3
        assert profiling.launch_counts()["ntt_fr"] == total["ntt_fr"] + 3
    finally:
        ntt.LAUNCHES.update(saved)


@pytest.mark.parametrize("planted", [False, True])
def test_assemble_counts_host_scalar_muls(prove, monkeypatch, planted):
    """`prove.assemble` carries the host scalar multiplications it ran:
    none, with a full-width blinding; one planted in each of its five
    affine conversions reads 5."""
    if planted:
        to_affine = prover.jac.to_affine_np

        def with_mul(ops, p):
            hc.g1_scalar_mul(hc.G1_GEN_PT, 3)
            return to_affine(ops, p)

        monkeypatch.setattr(prover.jac, "to_affine_np", with_mul)
    with profiling.tracing():
        prove(blinding=(2 ** 253 + 19, 3 ** 159))
    (asm,) = [s for s in profiling.spans() if s.name == "prove.assemble"]
    assert asm.attrs == {"host_scalar_muls": 5 if planted else 0}


FIELDS = ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2")


def test_prove_sets_keep_the_crs_fields(circuit, tmp_path):
    """The prove sets are built once; the CRS's four point sets keep their
    shapes, dtypes and values as views of the sets' first rows, and the
    `.npz` checkpoint round trip holds."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.utils import serialization as ser

    dq = circuit[0]
    crs = _small_crs(dq)
    before = {f: [a.clone() for a in getattr(crs, f)] for f in FIELDS}
    sets = prover.prove_sets(crs)
    assert prover.prove_sets(crs) is sets and crs.sets is sets
    n, n_delta = dq.n, dq.num_wires - dq.input - 1
    m = max(n + 3, n_delta)
    for f in FIELDS:
        for a, b, full in zip(getattr(crs, f), before[f], getattr(sets, f)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
            assert a.data_ptr() == full.data_ptr()
            assert full.shape[0] == (n + 2 if f == "xi_g2" else m)

    def rows(p, lo, hi):
        return prover.JPoint(*(a[lo:hi] for a in p))

    sg1, sg2 = crs.sigmag1, crs.sigmag2
    assert list(jac.to_affine_np(FQ_OPS, rows(sets.xi_g1, n, n + 3))) == [
        sg1.alpha, sg1.beta, sg1.delta]
    assert list(jac.to_affine_np(FQ2_OPS, rows(sets.xi_g2, n, n + 2))) == [
        sg2.beta, sg2.delta]
    for f, k in (("xi_g1", n + 3), ("xi_t_g1", n - 1),
                 ("sum_delta_g1", n_delta)):
        pad = rows(getattr(sets, f), k, m)
        assert list(jac.to_affine_np(FQ_OPS, pad)) == [None] * (m - k)
    path = str(tmp_path / "crs.npz")
    ser.device_crs_save(path, crs)
    again = ser.device_crs_load(path, device="cpu")
    assert again.sets is None
    for f in FIELDS:
        for a, b in zip(getattr(again, f), getattr(crs, f)):
            assert a.shape == b.shape and torch.equal(a, b)


def test_mesh_prove_runs_no_table_msm(circuit, monkeypatch):
    """The mesh path keeps the windowed MSMs: its prove builds no window
    tables and `prove.issue`'s `msm_tables` reads 0 (the mesh and its
    sharded step stood in for)."""
    from zksnark_tpu_torch.parallel import prove_sharded

    dq, _, wit, core = circuit
    crs = _small_crs(dq)
    steps = []

    def fake_step(mesh, domain, n_input, window_bits, ells, sets, *args,
                  **kwargs):
        steps.append(sets.tables)
        return core

    monkeypatch.setattr(prove_sharded, "sharded_prove_step", fake_step)
    with profiling.tracing():
        prover.device_prove(dq, crs, wit, blinding=(8, 9),
                            mesh=SimpleNamespace(size=2, rank=0))
    (issue,) = [s for s in profiling.spans() if s.name == "prove.issue"]
    assert issue.attrs["msm_tables"] == 0
    assert steps == [None] and crs.sets.tables is None


@pytest.mark.parametrize("room", [-1, 0])
def test_tables_only_where_they_fit(circuit, monkeypatch, room):
    """A CRS gets window tables where they take at most half of the device
    memory new tensors can take (here that memory is stood in for, and so
    is the tables' build), and decides once."""
    dq = circuit[0]
    crs = _small_crs(dq)
    sets = prover.prove_sets(crs)
    c = prover.msmod.pick_window_bits(dq.n)
    m = sets.xi_g1.z.shape[0]
    need = prover._table_bytes(sets, c)
    assert need == prover.msmod.table_windows(c) * (
        3 * m * 3 * 32 + (dq.n + 2) * 3 * 64)
    built = []

    def fake_build(sets, window_bits):
        built.append(window_bits)
        return dataclasses.replace(sets, tables=prover.WindowTables(
            window_bits, None, None))

    monkeypatch.setattr(prover, "_with_tables", fake_build)
    monkeypatch.setattr(prover, "_free_bytes", lambda dev: 2 * need + room)
    got = prover.prove_sets(crs, tables=True)
    assert built == ([] if room < 0 else [c])
    assert (got.tables is None) == (room < 0) and got is crs.sets
    monkeypatch.setattr(prover, "_free_bytes", lambda dev: 1 << 62)
    assert prover.prove_sets(crs, tables=True) is got
    assert len(built) == (room >= 0)
