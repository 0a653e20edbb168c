"""Run one cell of BENCHMARK.json once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (the circuit, compile_r1cs, device_setup, the pool's witnesses
and the warm-up requests, all drawn from --seed), then the traffic mix's
loop for --seconds, then the reference's check of the window's proofs.  The last line on standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `checks`, each number the reference
compared beside its limit (also the last lines on standard error).

Exit codes: 0 with a result; 2 without a CUDA card (or with fewer than
the cell asks for) or for an unknown cell; 3 when this process holds JAX
or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import session  # noqa: E402

# the prover's host work is one Python thread; torch's own pool stays at one
THREADS = 1


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:.1f}s] {msg}", file=sys.stderr,
          flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = session.find_cell(session.load_spec(), args.workload)
    except KeyError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    run = session.Run(cell, args.seed, bool(args.trace), "cuda", T0)
    run.setup()
    log(f"set-up {run.setup_s:.3f} s: " + ", ".join(
        f"{k} {sum(v):.3f}" for k, v in run.spans.items()))
    run.window(args.seconds)
    done = len(run.completed)
    lat = sorted(run.latencies_ms())
    log(f"window {run.window_s:.3f} s: {len(run.records)} requests, "
        f"{done} completed (the samples of every latency statistic); "
        f"latency ms min {lat[0]:.1f}, median {lat[len(lat) // 2]:.1f}, "
        f"max {lat[-1]:.1f}; memory peak "
        f"{run.memory_peak_bytes} B" if lat else "window: no request")
    log("latencies ms in order: " + " ".join(
        f"{x:.0f}" for x in run.latencies_ms()))
    if run.trace:
        log(f"card: {session.power_limit()}")
        run.collect()
    run.free()
    t = time.perf_counter()
    checks = run.judge()
    log(f"reference check {time.perf_counter() - t:.1f} s")
    found = session.jax_modules()
    if found:
        print(f"benchmark: this process holds {sorted(found)}",
              file=sys.stderr)
        return 3
    out = session.result(run, checks)
    for k, v in out["checks"].items():
        print(f"check {k}: {json.dumps(v)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
