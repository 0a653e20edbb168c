"""ctypes bridge to the native BN254 pairing library (`native/bn254.cc`).

The port's own copy of the JAX package's bridge: it compiles the
repository's C++ source into the port's build directory
(`zksnark_tpu_torch/_build/`) at first use and loads it from there; the
library's name carries a hash of the source and its header, so an
edited source is rebuilt.  When
the source or a C++ compiler is missing, or the build fails, it falls back
to the pure-Python pairing of `curve.bn254` (host code, not the device
path).

- `pairing_check(pairs)`: prod e(P_i, Q_i) == 1 (single final exp)

Byte layout (see native/bn254.cc): 32-byte little-endian plain-form field
elements; G1 = x||y, G2 = x0||x1||y0||y1; infinity = all-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "_build")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_NATIVE_DIR, "bn254.cc")
    try:
        h = hashlib.sha256()
        for name in ("bn254.cc", "bn254_constants.h"):
            with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libbn254_host_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-shared",
                 "-std=c++17", "-I", _NATIVE_DIR, "-o", tmp, src],
                check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.bn254_pairing_check.restype = ctypes.c_int
        lib.bn254_pairing_check.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        _LIB = lib
    except (OSError, subprocess.SubprocessError):
        _LIB = None
    return _LIB


def _g1_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")


def _g2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = p
    return (x0.to_bytes(32, "little") + x1.to_bytes(32, "little") +
            y0.to_bytes(32, "little") + y1.to_bytes(32, "little"))


def pairing_check(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod e(P_i, Q_i) == 1; native when available, python otherwise."""
    lib = _load()
    if lib is None:
        from . import bn254 as c

        return c.multi_pairing(pairs) == c.FQ12_ONE
    g1s = b"".join(_g1_bytes(p) for p, _ in pairs)
    g2s = b"".join(_g2_bytes(q) for _, q in pairs)
    return bool(lib.bn254_pairing_check(g1s, g2s, len(pairs)))
