"""The readers of the program's spans (`program_spans.py`) through the
harness: a traced run on the CPU at 7 gates reports the four host
stages and leaves out the two device spans; on the card (skipped
without one) all six, the host stages covering each prove."""

import pytest

from benchmark import session
from zksnark_tpu_torch.utils import profiling

SEED = 2 ** 31 + 1013
HOST = ("prove_encode_ms", "prove_issue_ms", "prove_wait_ms",
        "prove_assemble_ms")
DEVICE = ("quotient_device_ms", "msm_device_ms")
STAGES = ("prove.encode", "prove.issue", "prove.wait", "prove.assemble")


def traced_run(gates: int, device: str, seconds: float):
    cell = session.find_cell(session.load_spec(), "square_chain-2p20.prove")
    cell = cell._replace(config=dict(cell.config, gates=gates),
                         mix=dict(cell.mix, pool=2, warmup=1))
    profiling.clear_spans()
    run = session.Run(cell, SEED, True, device)
    run.setup()
    assert profiling.spans() == []          # warm-up: the profiler was off
    run.window(seconds)
    run.collect()
    return run, session.result(run, run.judge())


def coverage(spans):
    """Each root's share covered by its four host stages."""
    out = []
    for root in (s for s in spans if s.name == "prove"):
        kids = [s for s in spans if s.parent == root.id and s.name in STAGES]
        assert sorted(s.name for s in kids) == sorted(STAGES)
        out.append(sum(s.end_ns - s.start_ns for s in kids)
                   / (root.end_ns - root.start_ns))
    return out


def test_traced_cpu_run_reads_the_host_stages():
    import torch

    torch.set_num_threads(2)
    run, out = traced_run(7, "cpu", 0.001)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1
    m = out["metrics"]
    for name in HOST:
        assert m[name]["unit"] == "ms" and m[name]["value"] > 0, name
    for name in DEVICE:
        assert name not in m, name
    total = sum(m[name]["value"] for name in HOST)
    assert all(c > 0.99 for c in coverage(profiling.spans()))
    root = [s for s in profiling.spans() if s.name == "prove"][0]
    assert total <= (root.end_ns - root.start_ns) / 1e6
    # a root more than the completed requests, or a stage missing:
    # nothing is read
    spans = run.extra["program_spans"]
    other = root._replace(id=-1, prove=-1)
    run.extra["program_spans"] = spans + [other]
    assert all(session.metric_module(n).read(run) is None for n in HOST)
    run.extra["program_spans"] = [s for s in spans
                                  if s.name != "prove.wait"]
    assert session.metric_module("prove_wait_ms").read(run) is None
    assert session.metric_module("prove_issue_ms").read(run) > 0


@pytest.mark.cuda
def test_traced_card_run_reads_all_six(need_card):
    run, out = traced_run((1 << 12) - 1, "cuda", 2.0)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for name in HOST + DEVICE:
        assert m[name]["value"] > 0, name
    assert all(c >= 0.99 for c in coverage(profiling.spans()))
    # the stages cover the device's spans: the card's work ends in the wait
    assert (m["quotient_device_ms"]["value"] + m["msm_device_ms"]["value"]
            <= m["prove_issue_ms"]["value"] + m["prove_wait_ms"]["value"]
            + 1.0)
