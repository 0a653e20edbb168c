"""The control of `correct`: the reference put in the program's place,
with one guarantee of the configuration broken, must come out as not
correct.

    python3 -m benchmark.control --workload <cell> --seeds a,b,c
        [--requests N]

For each seed, the cell's trapdoor, statements and request stream as a
run draws them; the reference makes the first N requests' proofs with
the blinding left out (r = s = 0: every proof of a statement alike, so
no longer zero knowledge, and the host's blinding work skipped, the step
that would tempt a change), and the run's own judgement checks them.
One JSON line a seed; exit 0 when every seed's control is not correct.
The program is not run, so the control needs no card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from itertools import islice
from typing import NamedTuple

from . import generator, session
from .reference import groth16


class Proof(NamedTuple):
    a: object
    b: object
    c: object


def control_records(cell: session.Cell, seed: int, n: int, ref):
    """The first n requests with the reference's unblinded proofs."""
    cfg = cell.config
    mod = importlib.import_module(f"benchmark.circuits.{cfg['circuit']}")
    traffic = generator.Traffic(cell.mix, lambda rng: mod.statement(cfg, rng),
                                seed, groth16.R)
    trapdoor = generator.trapdoor(seed, groth16.R)
    lag = groth16.Lagrange(trapdoor[4], ref.n_gates)
    sums, records = {}, []
    for req in islice(traffic.requests(), n):
        if req.statement_id not in sums:
            sums[req.statement_id] = ref.sums(req.statement, lag)[0]
        pf = Proof(*groth16.proof(sums[req.statement_id], trapdoor, (0, 0)))
        records.append(session.Record(req, 0.0, pf))
    return trapdoor, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)
    cell = session.find_cell(session.load_spec(), args.workload)
    ref = session.reference_for(cell.config)
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        trapdoor, records = control_records(cell, seed, args.requests, ref)
        checks = session.judge(seed, trapdoor, records, ref)
        correct = session.passed(checks)
        caught &= not correct
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": correct,
                          "seconds": time.perf_counter() - t,
                          "checks": {k: {"value": v, how: lim} for k, (
                              v, lim, how) in checks.items()}}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
