"""One run of one cell: set-up, the measured window, and the judgement.

`Run(cell, seed, trace, device)` holds everything a metric reader reads
(`metrics/<name>.py`): the host-clock spans of set-up and of each request,
the prover's launch counters over the window, the profiler's reading of
the traced window, and what the readers' own `collect` hooks worked out
from the program's state after it.  The program is driven only through its entry points:
`compile_r1cs`, `device_setup` and `device_prove` (and, where a request
carries a fresh statement, the circuit's witness).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import queue
import sys
import threading
import time
import traceback
from collections import defaultdict
from itertools import islice
from typing import List, NamedTuple, Optional

from . import generator
from .reference import groth16

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "zksnark_tpu"}
# statements whose proofs the reference checks, at most, in a run (all of
# them where a pool repeats fewer)
MAX_STATEMENTS_CHECKED = 8


class Cell(NamedTuple):
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list        # BENCHMARK.json's metric entries of this cell
    per_layer: list


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, name: str, reported: set) -> bool:
    """Whether a per-layer metric is read in cell `name`, which reports
    the end-to-end metrics `reported`."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric["moves"] in reported


def find_cell(spec: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name, config, generator.load(w["traffic"]), w["chips"],
                e2e, layer)


def jax_modules(modules=None) -> set:
    """The forbidden top-level module names that this process holds (or
    that the names `modules` hold), compared whole."""
    names = sys.modules if modules is None else modules
    return {m.split(".", 1)[0] for m in names} & FORBIDDEN


def metric_module(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")


class Record(NamedTuple):
    request: generator.Request
    latency_s: float
    proof: object          # None when the request failed


class Run:
    def __init__(self, cell: Cell, seed: int, trace: bool = False,
                 device=None, t0: Optional[float] = None):
        import torch

        from zksnark_tpu_torch.field.host import FR
        from zksnark_tpu_torch.groth16 import prover

        self.cell, self.seed, self.trace = cell, seed, trace
        self.t0 = time.perf_counter() if t0 is None else t0
        self.torch, self.prover, self.p = torch, prover, FR.p
        self.device = torch.device(device or "cuda")
        self.cuda = self.device.type == "cuda"
        self.spans = defaultdict(list)
        self.extra: dict = {}
        self.setup_phases: dict = {}
        self.trace_data = None
        self.launches: dict = {}
        self.records: List[Record] = []
        self._reference = None
        self._lock = threading.Lock()
        self._builder = threading.Lock()

    # -- spans ----------------------------------------------------------
    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Host clock around the block (ended by a synchronize where
        `sync`), and a profiler span `bench.<name>` in a traced run."""
        rf = (self.torch.profiler.record_function(f"bench.{name}")
              if self.trace else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            yield
            if sync:
                self.sync()
        self.spans[name].append(time.perf_counter() - t)

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        cfg = self.cell.config
        mod = importlib.import_module(f"benchmark.circuits.{cfg['circuit']}")
        with self.span("circuit"):
            self.circuit = mod.Circuit(cfg)
            r1cs = self.circuit.r1cs()
        with self.span("compile", sync=True):
            self.dqap = self.prover.compile_r1cs(r1cs, device=self.device)
        del r1cs
        self.trapdoor = generator.trapdoor(self.seed, self.p)
        timer = None
        if self.trace:
            from zksnark_tpu_torch.utils.profiling import PhaseTimer

            timer = PhaseTimer()
        with self.span("crs_setup", sync=True):
            self.crs = self.prover.device_setup(
                self.dqap, trapdoor=self.trapdoor, timer=timer)
        self.setup_phases = dict(timer.phases) if timer else {}
        self.traffic = generator.Traffic(
            self.cell.mix, lambda rng: mod.statement(cfg, rng), self.seed,
            self.p)
        with self.span("pool"):
            self.pool = [self.circuit.witness(s) for s in self.traffic.pool]
        with self.span("warmup", sync=True):
            for req in islice(self.traffic.warmup(),
                              self.cell.mix["warmup"]):
                self.request(req)
        for name in ("witness", "device_prove"):
            self.spans.pop(name, None)
        self.setup_s = time.perf_counter() - self.t0

    def witness(self, req: generator.Request) -> list:
        if self.traffic.pool:
            return self.pool[req.statement_id]
        with self._builder, self.span("witness"):
            return self.circuit.witness(req.statement)

    def request(self, req: generator.Request):
        """One request: its witness where it carries a fresh statement,
        then the proof, back on the host.  (witness, proof)."""
        wit = self.witness(req)
        with self.span("device_prove"):
            return wit, self.prover.device_prove(
                self.dqap, self.crs, wit, blinding=req.blinding)

    # -- the window -----------------------------------------------------
    def launch_counts(self) -> dict:
        from zksnark_tpu_torch.ops import curve_kernels, montmul, ntt

        return {f"{m.__name__}.{k}": v
                for m in (montmul, ntt, curve_kernels)
                for k, v in m.LAUNCHES.items()}

    def window(self, seconds: float) -> None:
        """The mix's loop for `seconds`: closed, each client sends its next
        request when its last proof is back, until `seconds` have passed;
        open, the requests that arrive before `seconds` have passed queue
        and are served in order.  The window ends with the last proof; a
        request's latency runs from its sending (closed) or its arrival
        (open) to its proof."""
        torch = self.torch
        before = self.launch_counts()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        self._end = t0
        rf = (torch.profiler.record_function("bench.window")
              if self.trace else contextlib.nullcontext())
        with rf:
            if self.cell.mix["loop"] == "open":
                self._open(t0, t0 + seconds)
            else:
                self._closed(t0 + seconds)
        self.window_s = self._end - t0
        if self.cuda:
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        else:
            self.memory_peak_bytes = 0
        if prof is not None:
            prof.stop()
            from . import trace

            self.trace_data = trace.read(prof)
            del prof
        after = self.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}

    def _serve(self, req: generator.Request, start: float) -> None:
        try:
            wit, proof = self.request(req)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            wit, proof = None, None
        end = time.perf_counter()
        with self._lock:
            self.records.append(Record(req, end - start, proof))
            self._end = max(self._end, end)
            if proof is not None:
                self.last = (req, wit)

    def _workers(self, fn) -> None:
        """fn on the mix's clients: in this thread where there is one."""
        k = self.cell.mix["clients"]
        if k == 1:
            fn()
            return
        threads = [threading.Thread(target=fn) for _ in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _closed(self, deadline: float) -> None:
        reqs = self.traffic.requests()

        def client():
            while True:
                with self._lock:
                    if time.perf_counter() >= deadline:
                        return
                    req = next(reqs)
                self._serve(req, time.perf_counter())

        self._workers(client)

    def _open(self, t0: float, deadline: float) -> None:
        q: queue.Queue = queue.Queue()

        def server():
            while True:
                item = q.get()
                if item is None:
                    return
                self._serve(*item)

        k = self.cell.mix["clients"]
        threads = [threading.Thread(target=server) for _ in range(k)]
        for t in threads:
            t.start()
        for req, at in zip(self.traffic.requests(), self.traffic.arrivals()):
            when = t0 + at
            if when >= deadline:
                break
            wait = when - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            q.put((req, when))
        for _ in threads:
            q.put(None)
        for t in threads:
            t.join()

    @property
    def completed(self) -> List[Record]:
        return [r for r in self.records if r.proof is not None]

    def latencies_ms(self) -> List[float]:
        return [r.latency_s * 1e3 for r in self.records]

    # -- after the window ----------------------------------------------
    def reference(self):
        if self._reference is None:
            self._reference = reference_for(self.cell.config)
        return self._reference

    def collect(self) -> None:
        """The per-layer readers' own measurements, on the program's
        state, in a traced run."""
        for m in self.cell.per_layer:
            hook = getattr(metric_module(m["name"]), "collect", None)
            if hook is not None:
                hook(self)

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("crs", "dqap", "pool", "circuit", "last"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def judge(self) -> dict:
        return judge(self.seed, self.trapdoor, self.records,
                     self.reference())

    def metrics(self) -> dict:
        entries = self.cell.per_layer if self.trace else self.cell.end_to_end
        out = {}
        for m in entries:
            value = metric_module(m["name"]).read(self)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def judge(seed: int, trapdoor: tuple, records: List[Record], ref) -> dict:
    """Every proof of the window held against the reference's (all of
    at most MAX_STATEMENTS_CHECKED statements, drawn from the seed with
    the last request's).  {check: (value, limit, "max"|"min")}."""
    done = [r for r in records if r.proof is not None]
    by_stmt = defaultdict(list)
    for r in done:
        by_stmt[r.request.statement_id].append(r)
    ids = list(by_stmt)
    if len(ids) > MAX_STATEMENTS_CHECKED:
        rng = generator.stream(seed, "judge")
        ids = rng.sample(ids[:-1], MAX_STATEMENTS_CHECKED - 1) + ids[-1:]
    lag = groth16.Lagrange(trapdoor[4], ref.n_gates)
    checked = wrong = errors = 0
    for sid in ids:
        recs = by_stmt[sid]
        sums, errs = ref.sums(recs[0].request.statement, lag)
        errors += errs
        for r in recs:
            want = groth16.proof(sums, trapdoor, r.request.blinding)
            checked += 1
            wrong += not groth16.same(r.proof, want)
    return {"proofs_wrong": (wrong, 0, "max"),
            "requests_failed": (len(records) - len(done), 0, "max"),
            "reference_errors": (errors, 0, "max"),
            "proofs_checked": (checked, 1, "min")}


def reference_for(cfg: dict):
    mod = importlib.import_module(f"benchmark.reference.{cfg['circuit']}")
    return mod.Reference(cfg)


def passed(checks: dict) -> bool:
    return all(v <= lim if how == "max" else v >= lim
               for v, lim, how in checks.values())


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result(run: Run, checks: dict) -> dict:
    """The result line's object; `checks` comes last."""
    torch = run.torch
    done = run.completed
    device = {"platform": "gpu" if run.cuda else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.cuda else "cpu"),
              "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": passed(checks) and bool(done),
           "attempted": len(run.records),
           "failed": len(run.records) - len(done),
           "metrics": run.metrics(),
           "device": device}
    if run.trace and run.trace_data is not None:
        t = run.trace_data
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                            "idle_gaps": [list(x) for x in t.idle_gaps]}
    out["checks"] = {k: {"value": v, how: lim}
                     for k, (v, lim, how) in checks.items()}
    return out

