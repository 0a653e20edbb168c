"""Builds the CUDA kernels under `csrc/` and binds them with ctypes.

Each `.cu` source is compiled by `nvcc` for Hopper (sm_90a) into its own
shared library with a plain C interface, at first use, into `_build/`
beside this file (listed in `.gitignore`).  All sources are compiled at
once, one `nvcc` process each, and a library is rebuilt only when its
sources change (the file name carries a hash of them).  Nothing here runs
at import time: the CPU tests import every module on a host with no
`nvcc`.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a non-zero code.  A failed build
raises, and so does a failed launch: no wrapper falls back to the plain
PyTorch version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# source -> the headers it includes
SOURCES = {
    "montmul.cu": ("bn254_field.cuh",),
    "point_ops.cu": ("bn254_field.cuh", "point_core.cuh"),
    "point_scan.cu": ("bn254_field.cuh", "point_core.cuh"),
    "ntt.cu": ("bn254_field.cuh",),
    "mont_scan.cu": ("bn254_field.cuh",),
    "point_comb.cu": ("bn254_field.cuh", "point_core.cuh"),
    "point_tail.cu": ("bn254_field.cuh", "point_core.cuh"),
}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
SIGNATURES = {
    "montmul.cu": {"zk_montmul": [_P, _P, _P, _LL, _I, _P],
                   "zk_montmul_add": [_P, _P, _P, _P, _LL, _P],
                   "zk_wide_rows": [_P] * 6 + [_LL, _I, _P]},
    "point_ops.cu": {
        "zk_point_madd": [_I] + [_P] * 9 + [_LL, _P],
        "zk_point_add": [_I] + [_P] * 9 + [_LL, _P],
        "zk_point_double": [_I] + [_P] * 6 + [_LL, _P],
        "zk_point_double_n": [_I] + [_P] * 6 + [_LL, _I, _P],
    },
    "point_scan.cu": {
        "zk_point_add_scan": [_I] + [_P] * 9 + [_LL, _I, _LL, _I, _P],
        "zk_point_bucket_scan": [_I, _I] + [_P] * 13 + [_I, _LL, _I, _I, _P],
        "zk_point_horner": [_I] + [_P] * 6 + [_LL, _I, _I, _P],
    },
    "ntt.cu": {"zk_ntt_pass": [_P] * 3 + [_I] * 6 + [_P]},
    "mont_scan.cu": {"zk_mont_scan": [_I] + [_P] * 4 + [_LL, _I, _P],
                     "zk_normalize": [_I] + [_P] * 9 + [_LL, _P]},
    "point_comb.cu": {"zk_point_comb": [_I] + [_P] * 7 + [_LL, _P]},
    "point_tail.cu": {
        "zk_point_add_gather": [_I] + [_P] * 11 + [_LL, _P],
        "zk_point_abel": [_I] + [_P] * 12 + [_LL, _I, _P],
        "zk_point_block_scan": [_I] + [_P] * 9 + [_LL, _LL, _I, _I, _I, _P],
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
build_seconds = 0.0   # wall time of the last build() that compiled


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> str:
    h = hashlib.sha256()
    for name in (src,) + SOURCES[src]:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every stale library (in parallel) and load all of them.
    Returns {source: ctypes.CDLL}."""
    global build_seconds
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {src: _lib_path(src) for src in SOURCES}
    stale = {s: p for s, p in todo.items() if not os.path.exists(p)}
    if stale:
        t0 = time.time()
        nvcc = _nvcc()
        procs = {}
        for src, path in stale.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs[src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        errors = []
        for src, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            with open(os.path.join(BUILD_DIR, src + ".log"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src}:\n{out}")
            else:
                os.replace(tmp, path)
        if errors:
            raise RuntimeError("\n".join(errors))
        build_seconds = time.time() - t0
    for src, path in todo.items():
        lib = ctypes.CDLL(path)
        for fn, argtypes in SIGNATURES[src].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[src] = lib
    return _LIBS


def lib(src: str):
    return build()[src]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def build_log(src: str) -> str:
    """What nvcc printed for `src` (ptxas register and spill counts)."""
    path = os.path.join(BUILD_DIR, src + ".log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
