"""Times the bucket-scan kernel under other register caps.

`bucket_scan_kernel` (`csrc/point_scan.cu`) caps its registers through
the minimum blocks per SM of its `__launch_bounds__`: 11 for G1 and 6 for
G2, which hold it to 80 and 168 registers, no more than the elementwise
madd's 86 and 168.  This script builds `point_scan.cu` again with other
minimums, prints each build's ptxas registers and spills for the
bucket scan, and times each build's `bucket_scan` at one 2^20 MSM's shape
(16 windows of 16-bit digits, 64 sorted positions per lane, an affine
table with a point at infinity one time in 16), on the same inputs, in
the order A B C C B A, each output held bit-exact against the committed
build's.  Run from the repository's root on a machine with one CUDA card
and nvcc:

    python3 -m zksnark_tpu_torch.probe_register_caps

Builds go to `zksnark_tpu_torch/_build/caps/`.  The last line of output
is one JSON object with every reading.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from . import _build
from .curve import jacobian as jac
from .curve.field_ops import FQ2_OPS, FQ_OPS
from .ops import curve_kernels as ck

COMMITTED = re.compile(r"__launch_bounds__\(kBucketThreads,\s*sizeof\(E\) "
                       r"== sizeof\(Fe\) \? 11 : 6\)")
# name -> (G1, G2) minimum blocks per SM; None: no minimum
VARIANTS = {"uncapped": None, "min_10_8": (10, 8)}
W, C_BITS, N, CHUNK = 16, 16, 1 << 20, 64
ITERS = 5


def _variant_source(minimums) -> str:
    with open(os.path.join(_build.CSRC, "point_scan.cu")) as f:
        src = f.read()
    bounds = ("__launch_bounds__(kBucketThreads)" if minimums is None else
              "__launch_bounds__(kBucketThreads, sizeof(E) == sizeof(Fe) "
              f"? {minimums[0]} : {minimums[1]})")
    src, hits = COMMITTED.subn(bounds, src)
    if hits != 1:
        raise RuntimeError("the bucket scan's __launch_bounds__ (11 : 6) "
                           "is not in point_scan.cu")
    return src


def _start_builds() -> dict:
    out_dir = os.path.join(_build.BUILD_DIR, "caps")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, minimums in VARIANTS.items():
        cu = os.path.join(out_dir, f"point_scan_{name}.cu")
        with open(cu, "w") as f:
            f.write(_variant_source(minimums))
        so = os.path.join(out_dir, f"libpoint_scan_{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    return procs


def _load(so: str):
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES["point_scan.cu"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _bucket_scan_regs(log_text: str) -> dict:
    """{"g1"/"g2" (mixed-add instantiation): "N registers, spill ..."}."""
    out, mangled, spill = {}, "", ""
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "bucket_scan_kernel" in mangled \
                and "Lb1" in mangled:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out["g2" if "Fe2" in mangled else "g1"] = f"{regs} registers, " \
                                                      f"{spill}"
    return out


def _inputs(ops, elem, gen, dev):
    def rnd():
        # random limbs below p: clear the top limb's high bits
        t = torch.randint(-(1 << 31), 1 << 31, (N,) + elem + (8,),
                          dtype=torch.int64, device=dev, generator=gen)
        t[..., 7] &= 0x0FFFFFFF
        return t.to(torch.int32)

    zm = torch.randint(0, 16, (N,), device=dev, generator=gen) == 0
    tab = jac.JPoint(rnd(), rnd(), ops.select(
        zm, ops.zero((N,), dev), ops.one((N,), dev)).contiguous())
    d_sorted, order = torch.sort(torch.randint(
        0, 1 << C_BITS, (W, N), device=dev, generator=gen), dim=1)
    return (ops, tab, order, d_sorted, 1 << C_BITS, CHUNK, True)


def _time(args) -> tuple:
    out = ck.bucket_scan(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        ck.bucket_scan(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS, out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    procs = _start_builds()
    libs = {"min_11_6_committed": _build.lib("point_scan.cu")}
    regs = {"min_11_6_committed": _bucket_scan_regs(
        _build.build_log("point_scan.cu"))}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        libs[name], regs[name] = _load(so), _bucket_scan_regs(log)
    for name, r in regs.items():
        print(f"[ptxas] {name}: {r}", flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    names = list(libs)
    ms = {name: {"g1": [], "g2": []} for name in names}
    committed = libs[names[0]]
    with torch.inference_mode():
        for g, ops, elem in (("g1", FQ_OPS, ()), ("g2", FQ2_OPS, (2,))):
            args = _inputs(ops, elem, gen, dev)
            _build._LIBS["point_scan.cu"] = committed
            _, want = _time(args)    # a warm-up, not kept
            for name in names + names[::-1]:
                _build._LIBS["point_scan.cu"] = libs[name]
                t, got = _time(args)
                same = all(torch.equal(a, b) for a, b in zip(
                    (*got[0], got[1], got[2], *got[3]),
                    (*want[0], want[1], want[2], *want[3])))
                if not same:
                    raise RuntimeError(f"{name} disagrees with the committed "
                                       f"build on {g}")
                ms[name][g].append(t)
                print(f"[time] {g} {name}: {t:.4f} ms, bit-exact",
                      flush=True)
            del args, want
    _build._LIBS["point_scan.cu"] = committed
    print(json.dumps({"card": card, "shape": [W, C_BITS, N], "ms": ms,
                      "ptxas": regs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
