"""ctypes bridge to the native witness codec (`csrc/witness_codec.c`).

`encode(weights, num_wires, p)` makes the witness's (num_wires, 8) int32
limbs of x mod p, the bytes `MontCtx.to_limbs_np` makes of the weights
padded with zeros, in one pass over the sequence (`MontCtx.witness_limbs`
calls it).  The source is compiled against the interpreter's headers with
the host C compiler at first use, into the port's build directory
(`zksnark_tpu_torch/_build/`), under a name that carries a hash of the
source, the flags and the interpreter's version, and loaded with
`ctypes.PyDLL`, so the interpreter lock stays held and a Python error
raised inside propagates as it was raised.  When the source, the
compiler or the headers are missing, or the build fails, `encode`
returns None and `MontCtx.witness_limbs` runs `to_limbs_np`: the same
bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from .params import NUM_LIMBS

_LIB: Optional[ctypes.PyDLL] = None
_TRIED = False
_LOCK = threading.Lock()      # one build, whichever thread proves first

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "witness_codec.c")
_BUILD_DIR = os.path.join(_PKG, "_build")
_CFLAGS = ["-O2", "-DNDEBUG", "-fPIC", "-shared"]


def _load() -> Optional[ctypes.PyDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
    return _LIB


def _build_and_load() -> Optional[ctypes.PyDLL]:
    include = sysconfig.get_paths()["include"]
    try:
        h = hashlib.sha256(" ".join([sys.version] + _CFLAGS).encode())
        with open(_SRC, "rb") as f:
            h.update(f.read())
        so = os.path.join(_BUILD_DIR,
                          f"libwitness_codec_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["cc", *_CFLAGS, "-I", include, "-o", tmp, _SRC],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.PyDLL(so)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.zk_witness_limbs.restype = ctypes.c_longlong
    lib.zk_witness_limbs.argtypes = [
        ctypes.py_object, ctypes.c_ssize_t, ctypes.py_object,
        ctypes.c_void_p]
    return lib


def encode(weights: Sequence[int], num_wires: int,
           p: int) -> Optional[Tuple[np.ndarray, int]]:
    """(limbs, reduced): the (num_wires, 8) int32 limbs of each weight
    mod p, zero past the weights, and how many weights were not already
    ints in [0, p) and took `int(x) % p`; None where the library is not
    available.  Raises ValueError for more weights than wires, and where
    `int(x) % p` raises, as it raises."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((num_wires, NUM_LIMBS), dtype=np.int32)
    reduced = lib.zk_witness_limbs(weights, num_wires, p, out.ctypes.data)
    return out, reduced
