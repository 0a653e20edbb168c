"""The JAX package's interchange formats (version 1), in the port: the
device CRS, proofs and witnesses, so that a file written by either
package is read by the other.

- `proof_to_json` / `crs_to_json` / `witness_to_json` write the same
  text as the JAX package's codecs (hex field elements; G1 = [x, y], G2
  = [[x0, x1], [y0, y1]], null = infinity; a Z251 mock point is one hex
  int).
- `crs_from_jax_arrays` turns the arrays of a JAX `DeviceCRS` (numpy
  X/Y as (..., 32) float32 digits, Z as float32 or uint8 digits) and its
  host Sigma parts into the port's `DeviceCRS`: a re-chunk of the same
  little-endian bytes, since both packages hold the same Montgomery
  residues.
- `device_crs_save` / `device_crs_load` read and write the JAX package's
  `.npz` checkpoint (format version 1: `zksnark_tpu/utils/
  serialization.py`), so a CRS saved by either package proves in the
  other.  The host Sigma parts travel as the JSON of that format;
  `host_crs_load` reads only them (what verify needs).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..curve import jacobian as jac
from ..curve.field_ops import FQ2_OPS, FQ_OPS
from ..curve.jacobian import JPoint
from ..field.limb import limbs_from_jax_np, limbs_to_jax_np
from ..groth16.prover import DeviceCRS
from ..groth16.protocol import Proof, SigmaG1, SigmaG2

FORMAT_VERSION = 1


def _enc_g1(p) -> Optional[object]:
    """G1 affine (x, y), or a plain int for the Z251 mock backend."""
    if p is None:
        return None
    if isinstance(p, int):
        return hex(p)
    return [hex(p[0]), hex(p[1])]


def _dec_g1(v):
    if v is None:
        return None
    if isinstance(v, str):
        return int(v, 16)
    return (int(v[0], 16), int(v[1], 16))


def _enc_g2(p) -> Optional[object]:
    if p is None:
        return None
    if isinstance(p, int):
        return hex(p)
    (x0, x1), (y0, y1) = p
    return [[hex(x0), hex(x1)], [hex(y0), hex(y1)]]


def _dec_g2(v):
    if v is None:
        return None
    if isinstance(v, str):
        return int(v, 16)
    return ((int(v[0][0], 16), int(v[0][1], 16)),
            (int(v[1][0], 16), int(v[1][1], 16)))


def _check_version(d) -> None:
    if d["version"] != FORMAT_VERSION:
        raise ValueError(f"format version {d['version']} is not "
                         f"{FORMAT_VERSION}")


def proof_to_json(proof) -> str:
    return json.dumps({
        "version": FORMAT_VERSION,
        "curve": "bn254",
        "a": _enc_g1(proof.a),
        "b": _enc_g2(proof.b),
        "c": _enc_g1(proof.c),
    })


def proof_from_json(s: str) -> Proof:
    d = json.loads(s)
    _check_version(d)
    return Proof(a=_dec_g1(d["a"]), b=_dec_g2(d["b"]), c=_dec_g1(d["c"]))


def witness_to_json(weights) -> str:
    return json.dumps({"version": FORMAT_VERSION,
                       "weights": [hex(w) for w in weights]})


def witness_from_json(s: str):
    d = json.loads(s)
    _check_version(d)
    return [int(w, 16) for w in d["weights"]]


def crs_to_json(sigmag1, sigmag2) -> str:
    def g1_list(v):
        return None if v is None else [_enc_g1(p) for p in v]

    return json.dumps({
        "version": FORMAT_VERSION,
        "curve": "bn254",
        "g1": {
            "alpha": _enc_g1(sigmag1.alpha),
            "beta": _enc_g1(sigmag1.beta),
            "delta": _enc_g1(sigmag1.delta),
            "xi": g1_list(sigmag1.xi),
            "sum_gamma": g1_list(sigmag1.sum_gamma),
            "sum_delta": g1_list(sigmag1.sum_delta),
            "xi_t": g1_list(sigmag1.xi_t),
        },
        "g2": {
            "beta": _enc_g2(sigmag2.beta),
            "gamma": _enc_g2(sigmag2.gamma),
            "delta": _enc_g2(sigmag2.delta),
            "xi": None if sigmag2.xi is None else
            [_enc_g2(p) for p in sigmag2.xi],
        },
    })


def crs_from_json(s: str):
    d = json.loads(s)
    _check_version(d)

    def g1_list(v):
        return None if v is None else [_dec_g1(p) for p in v]

    g1, g2 = d["g1"], d["g2"]
    sigmag1 = SigmaG1(
        alpha=_dec_g1(g1["alpha"]), beta=_dec_g1(g1["beta"]),
        delta=_dec_g1(g1["delta"]), xi=g1_list(g1["xi"]),
        sum_gamma=g1_list(g1["sum_gamma"]),
        sum_delta=g1_list(g1["sum_delta"]), xi_t=g1_list(g1["xi_t"]))
    sigmag2 = SigmaG2(
        beta=_dec_g2(g2["beta"]), gamma=_dec_g2(g2["gamma"]),
        delta=_dec_g2(g2["delta"]),
        xi=None if g2["xi"] is None else [_dec_g2(p) for p in g2["xi"]])
    return sigmag1, sigmag2


def _points_from_jax(xyz, device) -> JPoint:
    return JPoint(*(torch.from_numpy(limbs_from_jax_np(a)).to(device)
                    for a in xyz))


def crs_from_jax_arrays(xi_g1, xi_t_g1, sum_delta_g1, xi_g2, sigmag1,
                        sigmag2, device=None) -> DeviceCRS:
    """A JAX `DeviceCRS`'s point sets, each an (x, y, z) triple of numpy
    digit arrays, plus its host Sigma parts (any objects with the
    SigmaG1 / SigmaG2 fields) -> the port's `DeviceCRS` on `device`."""
    dev = resolve_device(device)
    s1 = SigmaG1(alpha=sigmag1.alpha, beta=sigmag1.beta,
                 delta=sigmag1.delta, xi=sigmag1.xi,
                 sum_gamma=sigmag1.sum_gamma, sum_delta=sigmag1.sum_delta,
                 xi_t=sigmag1.xi_t)
    s2 = SigmaG2(beta=sigmag2.beta, gamma=sigmag2.gamma,
                 delta=sigmag2.delta, xi=sigmag2.xi)
    return DeviceCRS(
        xi_g1=_points_from_jax(xi_g1, dev),
        xi_t_g1=_points_from_jax(xi_t_g1, dev),
        sum_delta_g1=_points_from_jax(sum_delta_g1, dev),
        xi_g2=_points_from_jax(xi_g2, dev),
        sigmag1=s1, sigmag2=s2)


def device_crs_save(path: str, dcrs: DeviceCRS) -> None:
    """Write the JAX package's checkpoint: X/Y as float32 digits, Z as
    uint8 digits (exact: every Z is 0 or one)."""
    def xy(a):
        return limbs_to_jax_np(a.cpu().numpy())

    def z(a):
        return limbs_to_jax_np(a.cpu().numpy(), np.uint8)

    np.savez_compressed(
        path,
        xi_g1_x=xy(dcrs.xi_g1.x), xi_g1_y=xy(dcrs.xi_g1.y),
        xi_g1_z=z(dcrs.xi_g1.z),
        xi_t_x=xy(dcrs.xi_t_g1.x), xi_t_y=xy(dcrs.xi_t_g1.y),
        xi_t_z=z(dcrs.xi_t_g1.z),
        sd_x=xy(dcrs.sum_delta_g1.x), sd_y=xy(dcrs.sum_delta_g1.y),
        sd_z=z(dcrs.sum_delta_g1.z),
        xi_g2_x=xy(dcrs.xi_g2.x), xi_g2_y=xy(dcrs.xi_g2.y),
        xi_g2_z=z(dcrs.xi_g2.z),
        host_sigma=np.frombuffer(
            crs_to_json(dcrs.sigmag1, dcrs.sigmag2).encode(), dtype=np.uint8),
    )


def host_crs_load(path: str):
    """The host Sigma parts (SigmaG1, SigmaG2) of a checkpoint."""
    with np.load(path) as f:
        return crs_from_json(bytes(f["host_sigma"]).decode())


@torch.inference_mode()
def device_crs_load(path: str, device=None) -> DeviceCRS:
    """Load a checkpoint written by either package.  The point sets are
    re-normalized (Z in {0, one}) whatever wrote them, as the JAX loader
    does: the prover's mixed-add MSMs rely on it."""
    sigmag1, sigmag2 = host_crs_load(path)
    f = np.load(path)
    crs = crs_from_jax_arrays(
        (f["xi_g1_x"], f["xi_g1_y"], f["xi_g1_z"]),
        (f["xi_t_x"], f["xi_t_y"], f["xi_t_z"]),
        (f["sd_x"], f["sd_y"], f["sd_z"]),
        (f["xi_g2_x"], f["xi_g2_y"], f["xi_g2_z"]),
        sigmag1, sigmag2, device)
    return DeviceCRS(
        xi_g1=jac.batch_normalize(FQ_OPS, crs.xi_g1),
        xi_t_g1=jac.batch_normalize(FQ_OPS, crs.xi_t_g1),
        sum_delta_g1=jac.batch_normalize(FQ_OPS, crs.sum_delta_g1),
        xi_g2=jac.batch_normalize(FQ2_OPS, crs.xi_g2),
        sigmag1=sigmag1, sigmag2=sigmag2)
