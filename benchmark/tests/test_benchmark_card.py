"""On the card (skipped without one): a short run of a small square chain
through the harness, traced, is correct and reads its per-layer metrics
and breakdown."""

import pytest

from benchmark import session


@pytest.mark.cuda
def test_small_traced_run_on_the_card(need_card):
    cell = session.find_cell(session.load_spec(), "square_chain-2p20.prove")
    cell = cell._replace(config=dict(cell.config, gates=(1 << 12) - 1))
    run = session.Run(cell, 2 ** 31 + 5, True, "cuda")
    run.setup()
    run.window(2.0)
    run.collect()
    out = session.result(run, run.judge())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    for name in ("device_busy_ms", "device_idle_pct", "launches_per_prove",
                 "msm_roofline", "quotient_roofline"):
        assert name in out["metrics"], name
    for name in ("msm_roofline", "quotient_roofline"):
        assert 0 < out["metrics"][name]["value"] <= 105, name
    assert out["breakdown"]["device_ops"]
