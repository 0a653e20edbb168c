"""The harness on the CPU at a tiny square chain, past its look for a
card: a sound run is correct, and each fault the cells can have, planted
under the timed path, and the control come out not correct.  (One card,
so no exchange between chips to leave out.)"""

import json

import pytest

from benchmark import control, generator, session
from zksnark_tpu_torch.curve import bn254 as hc
from zksnark_tpu_torch.groth16.protocol import Proof

SEED = 2 ** 31 + 977


def tiny_cell(pool=2, warmup=1):
    cell = session.find_cell(session.load_spec(), "square_chain-2p20.prove")
    return cell._replace(config=dict(cell.config, gates=7),
                         mix=dict(cell.mix, pool=pool, warmup=warmup))


@pytest.fixture(scope="module")
def run():
    import torch

    torch.set_num_threads(2)
    r = session.Run(tiny_cell(), SEED, False, "cpu")
    r.setup()
    return r


def window(run, requests=1):
    run.records = []
    for _ in range(requests):
        run.window(0.001)          # one request each
    return session.passed(run.judge())


def patched(monkeypatch, run, fn):
    real = run.prover.device_prove
    monkeypatch.setattr(run.prover, "device_prove",
                        lambda dq, crs, w, blinding: fn(real, dq, crs, w,
                                                        blinding))


def test_sound_run_is_correct(run):
    assert window(run)
    out = session.result(run, run.judge())
    assert out["correct"] and out["attempted"] == 1
    assert list(out)[-1] == "checks"


def test_state_returned_unchanged(run, monkeypatch):
    first = {}

    def stale(real, dq, crs, w, blinding):
        if "p" not in first:
            first["p"] = real(dq, crs, w, blinding=blinding)
        return first["p"]

    patched(monkeypatch, run, stale)
    assert not window(run, requests=2)


def test_answer_altered_where_produced(run, monkeypatch):
    def altered(real, dq, crs, w, blinding):
        p = real(dq, crs, w, blinding=blinding)
        return Proof(a=p.a, b=p.b, c=hc.g1_add(p.c, p.c))

    patched(monkeypatch, run, altered)
    assert not window(run)


def test_half_of_the_terms_left_out(run, monkeypatch):
    def half(real, dq, crs, w, blinding):
        w = list(w)
        mid = len(w) // 2
        w[mid:] = [0] * (len(w) - mid)
        return real(dq, crs, w, blinding=blinding)

    patched(monkeypatch, run, half)
    assert not window(run)


def test_witness_altered_inside_the_request(run, monkeypatch):
    fresh = dict(run.cell.mix, pool=0)
    monkeypatch.setattr(run, "traffic", generator.Traffic(
        fresh, run.traffic.statement, SEED, run.p))
    assert window(run)            # the witness made inside the request
    real = run.circuit.witness

    def flipped(x):
        w = real(x)
        w[3] = (w[3] + 1) % run.p
        return w

    monkeypatch.setattr(run.circuit, "witness", flipped)
    assert not window(run)


def test_two_closed_loop_clients(run, monkeypatch):
    monkeypatch.setattr(run, "cell", run.cell._replace(
        mix=dict(run.cell.mix, clients=2)))
    run.records = []
    run.window(0.2)
    assert len(run.records) >= 2
    assert session.passed(run.judge())


def test_open_loop_serves_every_arrival_in_the_window(run, monkeypatch):
    mix = dict(run.cell.mix, loop="open", rate_per_s=8.0)
    monkeypatch.setattr(run, "cell", run.cell._replace(mix=mix))
    monkeypatch.setattr(run, "traffic", generator.Traffic(
        mix, run.traffic.statement, SEED, run.p))
    run.records = []
    run.window(0.25)
    due = sum(1 for _, t in zip(range(1000), generator.arrivals(SEED, 8.0))
              if t < 0.25)
    assert len(run.records) == due >= 1
    assert [r.request.index for r in run.records] == list(range(due))
    assert session.passed(run.judge())


@pytest.mark.parametrize("mix", [
    {"loop": "closed", "clients": 0, "pool": 4, "warmup": 2},
    {"loop": "open", "clients": 1, "pool": 4, "warmup": 2},
    {"loop": "open", "clients": 1, "pool": 4, "warmup": 2, "rate_per_s": 0},
    {"loop": "batch", "clients": 1, "pool": 4, "warmup": 2},
    {"loop": "closed", "clients": 1, "pool": 4, "warmup": 2, "rate": 1}])
def test_generator_refuses_a_malformed_mix(mix, tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "bad.json").write_text(json.dumps(mix))
    monkeypatch.setattr(generator, "HERE", str(tmp_path))
    with pytest.raises(ValueError):
        generator.load("bad")


def test_control_is_not_correct():
    cell = tiny_cell()
    ref = session.reference_for(cell.config)
    for seed in (SEED, SEED + 1, SEED + 2):
        trapdoor, records = control.control_records(cell, seed, 4, ref)
        checks = session.judge(seed, trapdoor, records, ref)
        assert not session.passed(checks)
        assert checks["proofs_wrong"][0] == 4
