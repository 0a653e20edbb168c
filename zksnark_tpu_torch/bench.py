"""Headline benchmark of the port: Groth16 prove wall time on the
square-chain circuit with 2^k - 1 gates, on the CUDA card.

    python -m zksnark_tpu_torch.bench [--log-n 20] [--repeats 2]
        [--details PATH] [--device cpu]

The counterpart of the JAX package's root `bench.py`: the same circuit,
trapdoor (11, 22, 33, 44, 55) and blinding (7, 9), and the same last
line on standard output,

    {"metric": "groth16_prove_2^<log_n>", "value": ms, "unit": "ms",
     "vs_baseline": x}

where `value` is the best of a warm prove and `--repeats` more (each
ended by `torch.cuda.synchronize()`, host assembly included) and
`vs_baseline` the speedup over `_reference_model_ms`, a cost model of
the reference prover's algorithms on a fast CPU.  The details (setup,
the warm prove, verify, one G1 MSM, one NTT and the montmul kernel's
rate over chained launches timed with CUDA events) go to `--details`, by
default `chiprun_out/bench_details.json` under the repository root.
Progress goes to standard error.

Two safeguards, as in the root `bench.py`: the environment variable
`BENCH_BUDGET_S` (default 3300) is the run's budget in seconds, and when
what is left of it runs short the repeats stop and the sub-metrics are
skipped; and SIGTERM flushes the details and prints the headline, once
a prove has been measured, then exits 0 (1 before the first measured
prove).  Either way the headline stays the last line on standard output.

It runs on the card and raises without one; `--device cpu` runs the
plain PyTorch versions of the kernels, for tests, at a small --log-n.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import torch

from ._device import resolve_device
from .field.host import FR
from .frontend.r1cs import R1CS

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DETAILS = os.path.join(_ROOT, "chiprun_out", "bench_details.json")
TRAPDOOR = (11, 22, 33, 44, 55)
BLINDING = (7, 9)
MONTMUL_CHAIN = 64      # chained launches timed for the montmul rate
SUBMETRIC_MIN_S = 120   # budget left that each sub-metric needs

# the running bench, for the SIGTERM handler: its start time, details
# and their path, its headline once a prove is measured, and whether the
# headline has been printed
_RUN: dict = {}


def _budget_s() -> float:
    return float(os.environ.get("BENCH_BUDGET_S", "3300"))


def _remaining() -> float:
    return _budget_s() - (time.time() - _RUN["t_start"])


def _flush() -> None:
    path = _RUN["path"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_RUN["details"], f, indent=2)


def _print_headline() -> None:
    print(json.dumps(_RUN["headline"]), flush=True)
    _RUN["printed"] = True


def _on_term(signum, frame):
    """Flush the details; print the headline if a prove was measured
    (and it is not already the last line); exit 0 if a verified prove
    was measured, else 1."""
    if "details" in _RUN:
        _RUN["details"]["killed_at_s"] = time.time() - _RUN["t_start"]
        _flush()
    head = _RUN.get("headline")
    if head and not _RUN.get("printed"):
        _print_headline()
    sys.stderr.flush()
    os._exit(0 if head and head["value"] > 0 else 1)


def synthetic_square_chain(n_gates: int):
    """Square-chain circuit: w_{i+1} = w_i * w_i, one gate per step.

    Wires: [unity, x (verify), t_1 .. t_n], gate i: t_{i+1} = t_i^2.
    Returns (R1CS, witness) with a satisfied assignment.
    """
    num_wires = n_gates + 2
    u = [[] for _ in range(num_wires)]
    v = [[] for _ in range(num_wires)]
    w = [[] for _ in range(num_wires)]
    for g in range(1, n_gates + 1):
        src = 1 if g == 1 else g  # wire feeding gate g
        dst = g + 1
        u[src].append((g, 1))
        v[src].append((g, 1))
        w[dst].append((g, 1))
    r1cs = R1CS(u=u, v=v, w=w, roots=list(range(1, n_gates + 1)), input=1)

    x = 3141592653
    wit = [1, x]
    cur = x
    for _ in range(n_gates):
        cur = cur * cur % FR.p
        wit.append(cur)
    return r1cs, wit


def _reference_model_ms(n_gates: int, num_wires: int) -> float:
    """Cost model of the reference prover at this size (generous to it).

    - weighted poly sums: 3 * num_wires * n field mults
    - h(x): convolution n^2 + long division n^2 field mults
    - per-coefficient exponentiations: (A:n + B_g1:n + B_g2:n*3 + C:2n)
      double-and-add scalar muls, ~380 group ops each
    Constants: 30 ns per 254-bit field mult, 0.5 us per G1 group op
    (both at the optimistic end of host Rust implementations).
    """
    field_mults = 3 * num_wires * n_gates + 2 * n_gates * n_gates
    group_ops = (1 + 1 + 3 + 2) * n_gates * 380
    return field_mults * 30e-9 * 1e3 + group_ops * 0.5e-6 * 1e3


def _log(t_start: float, msg: str) -> None:
    print(f"[bench +{time.time() - t_start:.0f}s] {msg}", file=sys.stderr,
          flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(seconds of one call after a warm-up call, on the host clock ended
    by a synchronize)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def _montmul_rate(dev, a: torch.Tensor):
    """Montgomery products per second of the montmul kernel: CUDA events
    around MONTMUL_CHAIN chained launches, y = y * a, on len(a) elements
    (None off the card)."""
    from .field.limb import FR_CTX
    from .ops.montmul import mont_mul

    if dev.type != "cuda":
        return None
    y = mont_mul(FR_CTX, a, a)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(MONTMUL_CHAIN):
        y = mont_mul(FR_CTX, y, a)
    end.record()
    torch.cuda.synchronize(dev)
    return MONTMUL_CHAIN * a.shape[0] / (start.elapsed_time(end) / 1e3)


def _submetrics(details: dict, dqap, crs, wit, t_start: float) -> None:
    """One G1 MSM over xi_g1 with the witness as scalars, one forward NTT
    and the montmul rate, at the domain's size; each is skipped once less
    than SUBMETRIC_MIN_S of the budget is left."""
    from .curve.field_ops import FQ_OPS
    from .field.limb import FR_CTX
    from .ops import msm as msmod
    from .ops import ntt as nttmod
    from .utils.profiling import ntt_work

    def skip(name):
        if _remaining() >= SUBMETRIC_MIN_S:
            return False
        details["skipped"] = details.get("skipped", []) + [name]
        _log(t_start, f"{name} skipped: {_remaining():.0f} s of the budget "
             "left")
        return True

    dev, n = dqap.device, dqap.n
    vals = wit[:n] + [0] * max(0, n - len(wit))
    if skip("msm_g1"):
        return
    scalars = torch.from_numpy(FR_CTX.to_limbs_np(vals)).to(dev)
    wb = msmod.pick_window_bits(n)
    msm_s = _timed(dev, lambda: msmod.msm_windowed(
        FQ_OPS, crs.xi_g1, scalars, wb, True))
    details["msm_g1_ms"] = msm_s * 1e3
    details["msm_gexp_per_s"] = n / msm_s
    _log(t_start, f"msm_g1 {msm_s * 1e3:.1f} ms")

    if skip("ntt"):
        return
    a = torch.from_numpy(FR_CTX.to_mont_np(vals)).to(dev)
    ntt_s = _timed(dev, lambda: nttmod.ntt(dqap.domain, a))
    details["ntt_ms"] = ntt_s * 1e3
    details["ntt_butterflies_per_s"] = ntt_work(n)["butterflies"] / ntt_s
    _log(t_start, f"ntt {ntt_s * 1e3:.2f} ms")

    if skip("montmul"):
        return
    rate = _montmul_rate(dev, a)
    details["montmul_n"] = n
    details["montmul_Mmul_per_s"] = None if rate is None else rate / 1e6


def run(log_n: int, repeats: int, details_path: str, device=None) -> dict:
    """The benchmark; returns the headline (also printed last)."""
    from .groth16 import protocol, prover
    from .groth16.backend import BN254Backend

    t_start = time.time()
    dev = resolve_device(device)
    details: dict = {"log_n": log_n, "device": str(dev),
                     "budget_s": _budget_s()}
    _RUN.clear()
    _RUN.update(t_start=t_start, details=details, path=details_path)
    if dev.type == "cuda":
        details["device_name"] = torch.cuda.get_device_name(dev)

    n_gates = (1 << log_n) - 1   # leave one slot: domain n = 2^log_n
    r1cs, wit = synthetic_square_chain(n_gates)
    dqap = prover.compile_r1cs(r1cs, device=dev)
    _log(t_start, f"device={dev} domain n={dqap.n} wires={dqap.num_wires}")

    t0 = time.time()
    crs = prover.device_setup(dqap, trapdoor=TRAPDOOR)
    _sync(dev)
    details["setup_s"] = time.time() - t0
    _log(t_start, f"device_setup {details['setup_s']:.2f} s (comb tables "
         "included)")

    t0 = time.time()
    proof = prover.device_prove(dqap, crs, wit, blinding=BLINDING)
    _sync(dev)
    t_warm = time.time() - t0
    details["prove_warmup_s"] = t_warm

    be = BN254Backend()
    pair = (crs.sigmag1, crs.sigmag2)
    ok = protocol.verify(be, pair, [wit[1]], proof)
    details["proof_verified"] = bool(ok)
    ref_ms = _reference_model_ms(n_gates, dqap.num_wires)
    details["prove_repeats_ms"] = []

    def measured(best_s):
        # the headline as it stands: printed by the SIGTERM handler from
        # here on
        details["prove_ms"] = best_s * 1e3
        details["vs_reference_model"] = ref_ms / (best_s * 1e3)
        _RUN["headline"] = {"metric": f"groth16_prove_2^{log_n}",
                            "value": best_s * 1e3, "unit": "ms",
                            "vs_baseline": ref_ms / (best_s * 1e3)}
        _flush()

    if ok:
        measured(t_warm)
    _log(t_start, f"prove warm-up {t_warm:.2f} s; proof verifies: {ok}")
    if not ok:
        _flush()
        _RUN["headline"] = {"metric": f"groth16_prove_2^{log_n}",
                            "value": -1, "unit": "ms", "vs_baseline": 0.0,
                            "error": "proof failed verification"}
        _print_headline()
        return _RUN["headline"]

    # verify_ms: the single-final-exponentiation path (native library)
    t0 = time.time()
    if not protocol.verify_fast(be, pair, [wit[1]], proof):
        raise RuntimeError("verify_fast rejected a proof verify accepted")
    details["verify_ms"] = (time.time() - t0) * 1e3

    best = t_warm
    for i in range(repeats):
        if _remaining() < 1.5 * best:
            details["repeats_stopped_at"] = i
            _log(t_start, f"repeats stopped after {i}: {_remaining():.0f} "
                 "s of the budget left")
            break
        t0 = time.time()
        prover.device_prove(dqap, crs, wit, blinding=BLINDING)
        _sync(dev)
        dt = time.time() - t0
        details["prove_repeats_ms"].append(dt * 1e3)
        best = min(best, dt)
        measured(best)
    _log(t_start, f"prove {best * 1e3:.1f} ms; reference model "
         f"{ref_ms:.0f} ms")

    _submetrics(details, dqap, crs, wit, t_start)
    details["total_s"] = time.time() - t_start
    _flush()
    _log(t_start, f"details: {json.dumps(details)}")
    _print_headline()
    return _RUN["headline"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--details", default=DEFAULT_DETAILS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                    "the plain versions of the kernels, for tests)")
    args = ap.parse_args(argv)
    saved = signal.signal(signal.SIGTERM, _on_term)
    try:
        headline = run(args.log_n, args.repeats, args.details, args.device)
    finally:
        signal.signal(signal.SIGTERM, saved)
    return 0 if headline["value"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
