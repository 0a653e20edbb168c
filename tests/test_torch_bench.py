"""The port's bench (`python -m zksnark_tpu_torch.bench`) under a kill and
a budget, as the root `bench.py` behaves: three `--device cpu --log-n 3`
processes, started together once for the module.

- SIGTERM after the first measured prove: the headline is the last line
  on standard output, the details are flushed with `killed_at_s`, exit 0;
- SIGTERM before any prove is measured: no headline, exit 1;
- `BENCH_BUDGET_S` small: the repeats stop and the sub-metrics are
  skipped, and the headline is still the last line, exit 0.
"""

import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(tmp, name, marker, budget=None):
    """A bench process; SIGTERM once `marker` shows on its standard error
    (None: never)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT
    env.pop("BENCH_BUDGET_S", None)
    if budget is not None:
        env["BENCH_BUDGET_S"] = str(budget)
    details = tmp / f"{name}.json"
    p = subprocess.Popen(
        [sys.executable, "-m", "zksnark_tpu_torch.bench", "--device", "cpu",
         "--log-n", "3", "--repeats", "50" if marker else "3",
         "--details", str(details)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return p, details, marker


def _finish(p, marker, timeout=300):
    """(exit code, stdout lines, stderr) of the process, sending SIGTERM
    at its marker."""
    err = []
    t0 = time.time()
    if marker:
        for line in p.stderr:
            err.append(line)
            if marker in line:
                p.send_signal(signal.SIGTERM)
                break
            assert time.time() - t0 < timeout, "".join(err)[-2000:]
    out, rest = p.communicate(timeout=timeout)
    return p.returncode, out.strip().splitlines(), "".join(err) + rest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    procs = {"killed": _start(tmp, "killed", "prove warm-up"),
             "early": _start(tmp, "early", "domain n="),
             "budget": _start(tmp, "budget", None, budget=1)}
    try:
        # each process is watched by its own thread: a marker must be
        # caught when it shows, not when the other processes are done
        with ThreadPoolExecutor(len(procs)) as pool:
            done = {k: pool.submit(_finish, p, m)
                    for k, (p, _, m) in procs.items()}
            return {k: f.result() + (procs[k][1],) for k, f in done.items()}
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()


def _headline(lines):
    head = json.loads(lines[-1])
    assert head["metric"] == "groth16_prove_2^3" and head["unit"] == "ms"
    assert head["value"] > 0 and head["vs_baseline"] > 0
    return head


def test_sigterm_after_a_measured_prove_prints_the_headline(runs):
    rc, lines, err, details = runs["killed"]
    assert rc == 0, err[-2000:]
    head = _headline(lines)
    assert len(lines) == 1
    d = json.loads(details.read_text())
    assert d["killed_at_s"] > 0 and d["proof_verified"] is True
    assert d["prove_ms"] == head["value"]
    assert len(d["prove_repeats_ms"]) < 50


def test_sigterm_before_a_measured_prove_exits_1(runs):
    rc, lines, err, details = runs["early"]
    assert rc == 1, err[-2000:]
    assert lines == []
    assert json.loads(details.read_text())["killed_at_s"] > 0


def test_small_budget_stops_the_repeats(runs):
    rc, lines, err, details = runs["budget"]
    assert rc == 0, err[-2000:]
    head = _headline(lines)
    d = json.loads(details.read_text())
    assert d["budget_s"] == 1
    assert d["repeats_stopped_at"] == 0 and d["prove_repeats_ms"] == []
    assert d["skipped"] == ["msm_g1"]
    assert "msm_g1_ms" not in d and "ntt_ms" not in d
    assert d["prove_ms"] == head["value"] == d["prove_warmup_s"] * 1e3
    assert "killed_at_s" not in d
