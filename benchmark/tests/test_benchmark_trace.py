"""The reading of a traced window: each prove's kernels, and the stages
the roofline readers split a prove into, on made-up intervals."""

import pytest

from benchmark import trace

MS = 1_000_000     # ns


def prove(t0, names, gap=0):
    """Kernels of 1 ms each, one after the other from t0 (ms)."""
    out, t = [], t0 * MS
    for name in names:
        out.append((t, t + MS, name))
        t += MS + gap
    return out


KERNELS = ["montmul_kernel", "at::native::index_kernel", "montmul_kernel",
           "ntt_pass_kernel", "ntt_pass_kernel", "montmul_kernel",
           "at::native::elementwise_kernel", "montmul_kernel",
           "at::native::CatArrayBatchedCopy", "bucket_scan_kernel",
           "horner_kernel"]
THEN = "montmul|elementwise"


def test_proves_take_the_kernels_inside_each_span():
    dev = (prove(10, KERNELS) + [(21 * MS, 22 * MS, "Memcpy DtoH")]
           + prove(30, KERNELS[:3]))
    spans = [(9 * MS, 23 * MS), (29 * MS, 40 * MS)]
    got = trace._proves(sorted(dev), spans, 0, 100 * MS)
    assert [[k[2] for k in p] for p in got] == [KERNELS, KERNELS[:3]]
    # spans outside the window are left out; overlapping spans keep none
    assert len(trace._proves(sorted(dev), spans, 0, 25 * MS)) == 1
    assert trace._proves(dev, [(0, 20 * MS), (10 * MS, 30 * MS)], 0,
                         100 * MS) is None


def test_stages_split_at_the_last_ntt_and_the_products_after_it():
    kernels = prove(0, KERNELS)
    before = trace.before_split("ntt", then=THEN)(kernels)
    after = trace.after_split("ntt", then=THEN)(kernels)
    assert [k[2] for k in before] == KERNELS[:8]
    assert [k[2] for k in after] == KERNELS[8:]
    assert trace.split_after(kernels, "ntt", then="montmul") == 6
    assert trace.before_split("sort")(kernels) is None
    assert trace.split_after(kernels, "ntt") == 5


def test_busy_seconds_is_the_union():
    assert trace.busy_seconds([(0, 10, "a"), (5, 15, "b"), (20, 30, "c"),
                               (22, 25, "d")]) == pytest.approx(25e-9)


def test_stage_seconds_is_the_mean_over_proves():
    data = trace.TraceData(1.0, 0.5, [], [], [
        prove(0, KERNELS, gap=MS), prove(50, KERNELS[:5] + KERNELS[8:])])
    pick = trace.after_split("ntt", then=THEN)
    assert trace.stage_seconds(data, pick) == pytest.approx(3e-3)
    assert trace.stage_seconds(data, trace.before_split("sort")) is None
    assert trace.stage_seconds(data._replace(proves=None), pick) is None
    assert trace.stage_seconds(None, pick) is None
