#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`zksnark_tpu_torch`) on one card.

    python3 chip_smoke.py                  # n = 2^20, three proves
    python3 chip_smoke.py --profile TABLE  # and one prove broken down

Phases, each of which must pass (the script exits non-zero otherwise):

1. build: `nvcc` compiles every kernel source under
   `zksnark_tpu_torch/csrc/` (one process per source, in parallel).
2. kernels: each kernel entry — K1 montmul (Fr, Fq); K2 madd, K3 add,
   K4 double (G1, G2); the MSM's chains K2 bucket_scan, K3 add_scan, K4
   double_n and horner (G1, G2); and the NTT passes — runs on 2^16
   random inputs plus the edge cases (0, 1, p-1; P = Q, P = -Q, P = inf,
   Q = inf, a malformed Z; for the chains a step at infinity, a step
   equal to the accumulator, a step equal to its negation, a lane all at
   infinity, k = 0 and 1, window sums at infinity; for the bucket scan a
   bucket whose points cancel, a bucket of equal points, infinity table
   entries, empty buckets, runs across chunks and an n that is not a
   multiple of 64, mixed and general adds; for the NTT every log_n from 1
   to 20, forward and inverse, in the default passes and in an uneven
   split) and must equal its plain PyTorch version on the same CUDA
   inputs bit for bit; the edge cases built from real curve points (and
   a small NTT against the host DFT) must also equal the host
   arithmetic.  Each entry and its plain version then run on the same
   random CUDA inputs at the shapes the main path gives it: the two
   outputs must again be equal bit for bit, and both are timed with CUDA
   events, the chains, the bucket scan and the NTT also beside the loop
   of launches that each replaces.
3. reference: a small circuit (n = 2^3) proves on the card and with the
   plain versions on the CPU; the two proofs must be equal.
4. path: the main path at full size — the square-chain circuit with
   n = 2^20 gates, `compile_r1cs`, `device_setup`, then three
   `device_prove` calls with distinct blindings; each proof must verify
   on its public input x and be rejected on x + 1.  The kernel launch
   counts are reset just before setup and read after it and after each
   prove; every kernel entry of the path must have launched (all but the
   elementwise double, whose chains now run in double_n and horner), and
   each prove must launch the bucket scan once per MSM (four G1, one
   G2), the elementwise madd not at all (setup's comb encryption still
   runs it) and the NTT kernel once per pass of its seven transforms.

The last lines are the kernels' JSON summary, the card's name and power
limit (nvidia-smi), and {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and
# 32-bit integer multiply-adds/s taken as half
# the 67 TFLOP/s float32 rate (an FMA is 2 FLOPs; an SM has 64 INT32 lanes
# for 128 FP32 lanes)
PEAK_BYTES_S = 3.35e12
PEAK_IMAD_S = 67e12 / 2 / 2

# 32-bit multiply-adds per Montgomery product (CIOS, 8 words: 8 rows of
# a*b_i and m*p, low and high halves, plus the 8 quotient digits) and
# 32-bit add/sub instructions per modular add or sub (8-word chain plus the
# 8-word conditional subtract)
IMAD_PER_MUL = 8 * (2 * 16 + 1)
SEED = 20261016                  # of every random input
OPS_PER_ADD = 16

TPU_KERNELS = {
    "montmul": "zksnark_tpu/ops/montmul.py:42",
    "ntt": "zksnark_tpu/ops/montmul.py:42",
    "madd": "zksnark_tpu/ops/curve_pallas.py:291",
    "bucket_scan": "zksnark_tpu/ops/curve_pallas.py:291",
    "add": "zksnark_tpu/ops/curve_pallas.py:281",
    "double": "zksnark_tpu/ops/curve_pallas.py:301",
    "add_scan": "zksnark_tpu/ops/curve_pallas.py:281",
    "double_n": "zksnark_tpu/ops/curve_pallas.py:301",
    "horner": "zksnark_tpu/ops/curve_pallas.py:301",
}
SOURCES = {
    "montmul": "zksnark_tpu_torch/csrc/montmul.cu",
    "ntt": "zksnark_tpu_torch/csrc/ntt.cu",
    "madd": "zksnark_tpu_torch/csrc/point_ops.cu",
    "bucket_scan": "zksnark_tpu_torch/csrc/point_scan.cu",
    "add": "zksnark_tpu_torch/csrc/point_ops.cu",
    "double": "zksnark_tpu_torch/csrc/point_ops.cu",
    "add_scan": "zksnark_tpu_torch/csrc/point_scan.cu",
    "double_n": "zksnark_tpu_torch/csrc/point_ops.cu",
    "horner": "zksnark_tpu_torch/csrc/point_scan.cu",
}
# the elementwise double has no launch on the main path: the MSM's
# doubling chains run in double_n and horner
OFF_PATH = ("double_g1", "double_g2")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------------------
# the workload: a square chain w_{i+1} = w_i^2, one gate per step
# ---------------------------------------------------------------------------

def synthetic_square_chain(n_gates: int):
    """Wires [unity, x (verify), t_1 .. t_n]; gate i: t_{i+1} = t_i^2.
    Returns (R1CS, satisfied witness).  The JAX package's benchmark
    circuit (`bench.py`)."""
    from zksnark_tpu_torch.field import params
    from zksnark_tpu_torch.frontend.r1cs import R1CS

    num_wires = n_gates + 2
    u = [[] for _ in range(num_wires)]
    v = [[] for _ in range(num_wires)]
    w = [[] for _ in range(num_wires)]
    for g in range(1, n_gates + 1):
        src = 1 if g == 1 else g
        u[src].append((g, 1))
        v[src].append((g, 1))
        w[g + 1].append((g, 1))
    r1cs = R1CS(u=u, v=v, w=w, roots=list(range(1, n_gates + 1)), input=1)
    x = 3141592653
    wit = [1, x]
    cur = x
    for _ in range(n_gates):
        cur = cur * cur % params.R
        wit.append(cur)
    return r1cs, wit


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

class CountingOps:
    """Stands in for FqOps / Fq2Ops and counts base-field multiplies and
    adds, to derive each point formula's operation count from the plain
    version itself."""

    def __init__(self, ops):
        self.ops, self.muls, self.adds = ops, 0, 0
        self.elem_ndim = ops.elem_ndim
        self.fq2 = ops.elem_ndim == 2

    def _mul(self):
        self.muls += 3 if self.fq2 else 1
        self.adds += 5 if self.fq2 else 0

    def mul(self, a, b):
        self._mul()
        return self.ops.mul(a, b)

    def sqr(self, a):
        self.muls += 2 if self.fq2 else 1
        self.adds += 3 if self.fq2 else 0
        return self.ops.sqr(a)

    def _add(self):
        self.adds += 2 if self.fq2 else 1

    def add(self, a, b):
        self._add()
        return self.ops.add(a, b)

    def sub(self, a, b):
        self._add()
        return self.ops.sub(a, b)

    def dbl(self, a):
        self._add()
        return self.ops.dbl(a)

    def __getattr__(self, name):
        return getattr(self.ops, name)


def rand_field(rng: np.random.Generator, p: int, shape) -> list:
    n = int(np.prod(shape))
    raw = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64)
    vals = [int(a) << 252 ^ int(b) << 189 ^ int(c) << 126 ^ int(d) << 63
            ^ int(e) for a, b, c, d, e in raw.tolist()]
    return np.array([v % p for v in vals], dtype=object).reshape(shape)


def time_cuda(fn, iters: int):
    """(mean milliseconds per call, CUDA events around `iters` calls after
    a warm-up call; the warm-up call's output)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def limb_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |difference| between two limb tensors, as u32 limbs."""
    d = ((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF))
    return int(d.abs().max().item()) if d.numel() else 0


def kernel_phase(dev, seed: int, n_rand: int, results: dict) -> None:
    from zksnark_tpu_torch.curve import bn254 as hc
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.field.limb import FQ_CTX, FR_CTX
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import montmul as mm

    rng = np.random.default_rng(seed)
    hrng = random.Random(seed)

    # -- K1 ------------------------------------------------------------------
    for ctx, name in ((FR_CTX, "montmul_fr"), (FQ_CTX, "montmul_fq")):
        p = ctx.p
        edge = [0, 1, p - 1, p - 2, (p - 1) // 2, ctx.r_int]
        ea = [x for x in edge for _ in edge]
        eb = [y for _ in edge for y in edge]
        a = np.concatenate([rand_field(rng, p, (n_rand,)), ea])
        b = np.concatenate([rand_field(rng, p, (n_rand,)), eb])
        ta = torch.from_numpy(ctx.to_limbs_np(a)).to(dev)
        tb = torch.from_numpy(ctx.to_limbs_np(b)).to(dev)
        got = mm.mont_mul(ctx, ta, tb)
        want = mm.mont_mul_plain(ctx, ta, tb)
        torch.cuda.synchronize()
        err = limb_err(got, want)
        vals = ctx.from_limbs_np(got[-len(ea):].cpu().numpy())
        rinv = pow(1 << 256, -1, p)
        sem = all(int(v) == x * y * rinv % p
                  for v, x, y in zip(vals, ea, eb))
        results[name] = {"max_abs_err": err, "bit_exact": err == 0,
                         "host_edge_ok": sem, "n_checked": len(a)}
        log(f"[kernels] {name}: {len(a)} products, max |kernel - plain| "
            f"= {err}, edge values vs host ints {'ok' if sem else 'FAIL'}")

    # -- K2-K4 ----------------------------------------------------------------
    for ops, g in ((FQ_OPS, "g1"), (FQ2_OPS, "g2")):
        g1 = g == "g1"
        ecount = () if g1 else (2,)
        q = FQ_CTX.p
        gen = hc.G1_GEN_PT if g1 else hc.G2_GEN
        smul = hc.g1_scalar_mul if g1 else hc.g2_scalar_mul
        hadd = hc.g1_add if g1 else hc.g2_add
        hneg = hc.g1_neg if g1 else hc.g2_neg

        def mont(vals):
            return torch.from_numpy(ops.to_mont_np(vals)).to(dev)

        def pts(host):
            """host affine points (None = inf) -> Jacobian, Z in {0, one}"""
            zero = 0 if g1 else (0, 0)
            x = mont([zero if h is None else list(h[0]) if not g1 else h[0]
                      for h in host])
            y = mont([zero if h is None else list(h[1]) if not g1 else h[1]
                      for h in host])
            inf = torch.tensor([h is None for h in host], device=dev)
            z = ops.select(inf, ops.zero((len(host),), dev),
                           ops.one((len(host),), dev))
            return jac.JPoint(x, y, z)

        def scaled(p, lam):
            """(l^2 X, l^3 Y, l Z): the same point, another Z"""
            lm = mont([lam] if g1 else [[lam, 0]])[0]
            l2 = ops.mul(lm, lm)
            return jac.JPoint(ops.mul(p.x, l2), ops.mul(p.y, ops.mul(l2, lm)),
                              ops.mul(p.z, lm))

        def cat(*ps):
            return jac.JPoint(*(torch.cat(c) for c in zip(*ps)))

        ks = [hrng.randrange(1, FR_CTX.p) for _ in range(4)]
        A, B, C, D = (smul(gen, k) for k in ks)
        # edge rows: real points, with what the host curve says they sum to
        P_edge = cat(pts([A]), scaled(pts([A]), 7), pts([A]), pts([None]),
                     pts([A]), pts([None]), pts([C]), scaled(pts([C]), 5))
        Q_edge = pts([A, A, hneg(A), B, None, None, D, D])
        want_edge = [hadd(A, A), hadd(A, A), None, B, A, None, hadd(C, D),
                     hadd(C, D)]
        # a malformed Z (Z = q: zero mod q, nonzero limbs) on both sides
        mal = np.zeros((1,) + ecount + (8,), dtype=np.int32)
        mal.reshape(-1, 8)[0] = np.frombuffer(q.to_bytes(32, "little"),
                                              dtype="<i4")
        malformed = torch.from_numpy(mal).to(dev)
        Pm = jac.JPoint(pts([B]).x, pts([B]).y, malformed)

        def rnd(shape):
            return torch.from_numpy(FQ_CTX.to_limbs_np(
                rand_field(rng, q, shape + ecount))).to(dev)

        zmask = torch.from_numpy(rng.random(n_rand) < 1 / 16).to(dev)
        P_rand = jac.JPoint(rnd((n_rand,)), rnd((n_rand,)), rnd((n_rand,)))
        Q_rand = jac.JPoint(rnd((n_rand,)), rnd((n_rand,)), ops.select(
            zmask, ops.zero((n_rand,), dev), ops.one((n_rand,), dev)))
        P = cat(P_rand, P_edge, Pm, pts([B]))
        Q = cat(Q_rand, Q_edge, pts([C]), jac.JPoint(
            pts([B]).x, pts([B]).y, malformed))
        ne = len(want_edge)
        edge = slice(n_rand, n_rand + ne)

        checks = {
            "madd": (ck.madd, ck.madd_plain, (P, Q)),
            "add": (ck.add, ck.add_plain, (P, Q)),
            "double": (ck.double, ck.double_plain, (P,)),
        }
        for op, (kern, plain, args) in checks.items():
            name = f"{op}_{g}"
            got = kern(ops, *args)
            want = plain(ops, *args)
            torch.cuda.synchronize()
            err = max(limb_err(a, b) for a, b in zip(got, want))
            aff = jac.to_affine_np(ops, jac.JPoint(*(c[edge] for c in got)))
            if op == "double":
                host_want = [smul(h, 2) if h is not None else None
                             for h in [A, A, A, None, A, None, C, C]]
            else:
                host_want = want_edge
            if not g1:
                aff = [None if a is None else tuple(map(tuple, a))
                       for a in aff]
            sem = list(aff) == host_want
            results[name] = {"max_abs_err": err, "bit_exact": err == 0,
                             "host_edge_ok": sem, "n_checked": P.z.shape[0]}
            log(f"[kernels] {name}: {P.z.shape[0]} points, max |kernel - "
                f"plain| = {err}, edge cases vs host curve "
                f"{'ok' if sem else 'FAIL'}")

        # -- the chains ----------------------------------------------------
        def affine(p):
            aff = jac.to_affine_np(ops, p)
            return [None if a is None else a if g1 else tuple(map(tuple, a))
                    for a in aff]

        def err_of(a, b):
            return max(limb_err(u, v) for u, v in zip(a, b))

        # add_scan: random lanes, (B, 16 steps, 16), a step at infinity
        # 1 time in 16; edge lanes (4, 4, 1): A + A doubles, then a step
        # at infinity; C + (-C) cancels, then D + D doubles; all at
        # infinity; and A + A, + B, + (-B) with another Z
        P_inf = P_rand._replace(z=ops.select(
            zmask, ops.zero((n_rand,), dev), P_rand.z))
        grid_r = jac.JPoint(*(c.reshape((n_rand // 256, 16, 16) + c.shape[1:])
                              for c in P_inf))
        lanes = [[A, A, B, None], [C, hneg(C), D, D], [None] * 4]
        grid_e = cat(pts([p for lane in lanes for p in lane]),
                     scaled(pts([A, A, B, hneg(B)]), 7))
        grid_e = jac.JPoint(*(c.reshape((4, 4, 1) + c.shape[1:])
                              for c in grid_e))
        err = 0
        for grid in (grid_r, grid_e):
            for collect in (True, False):
                got = ck.add_scan(ops, grid, collect)
                want = ck.add_scan_plain(ops, grid, collect)
                torch.cuda.synchronize()
                err = max(err, err_of(got[0], want[0]))
                if collect:
                    err = max(err, err_of(got[1], want[1]))
        totals = ck.add_scan(ops, grid_e, False)[0]
        sem = affine(jac.JPoint(*(c[:, 0] for c in totals))) == [
            hadd(hadd(A, A), B), hadd(D, D), None, hadd(A, A)]
        n_pts = grid_r.z.shape[0] * 256 + 16
        results[f"add_scan_{g}"] = {"max_abs_err": err, "bit_exact": err == 0,
                                    "host_edge_ok": sem, "n_checked": n_pts}
        log(f"[kernels] add_scan_{g}: {n_pts} points in lanes of 16 and 4 "
            f"steps, collect on and off, max |kernel - plain| = {err}, edge "
            f"lanes vs host curve {'ok' if sem else 'FAIL'}")

        # double_n: k = 0, 1, 16 on random points and on A, 5C, inf
        pd = cat(P_rand, pts([A]), scaled(pts([C]), 5), pts([None]))
        err, sem = 0, True
        for k in (0, 1, 16):
            got = ck.double_n(ops, pd, k)
            want = ck.double_n_plain(ops, pd, k)
            torch.cuda.synchronize()
            err = max(err, err_of(got, want))
            sem &= affine(jac.JPoint(*(c[n_rand:] for c in got))) == [
                smul(A, 1 << k), smul(C, 1 << k), None]
        results[f"double_n_{g}"] = {"max_abs_err": err, "bit_exact": err == 0,
                                    "host_edge_ok": sem,
                                    "n_checked": pd.z.shape[0]}
        log(f"[kernels] double_n_{g}: {pd.z.shape[0]} points, k = 0, 1, 16, "
            f"max |kernel - plain| = {err}, edge points vs host curve "
            f"{'ok' if sem else 'FAIL'}")

        # horner: random window sums (16 windows x m MSMs, a sum at
        # infinity 1 time in 16) and (4 windows x 3 MSMs) of real points:
        # all finite, all at infinity, every other one at infinity
        m = min(256, n_rand // 16)
        sums_r = jac.JPoint(*(c[:16 * m].reshape((16, m) + c.shape[1:])
                              for c in P_inf))
        cols = [[A, B, C, D], [None] * 4, [A, None, B, None]]
        sums_e = pts([cols[m][w] for w in range(4) for m in range(3)])
        sums_e = jac.JPoint(*(c.reshape((4, 3) + c.shape[1:])
                              for c in sums_e))
        err = 0
        for sums in (sums_r, sums_e):
            got = ck.horner(ops, sums, 16)
            want = ck.horner_plain(ops, sums, 16)
            torch.cuda.synchronize()
            err = max(err, err_of(got, want))
        r = FR_CTX.p
        host_want = []
        for col in cols:
            acc = None
            for w, h in enumerate(col):
                if h is not None:
                    acc = hadd(acc, smul(h, pow(2, 16 * w, r)))
            host_want.append(acc)
        sem = affine(ck.horner(ops, sums_e, 16)) == host_want
        results[f"horner_{g}"] = {"max_abs_err": err, "bit_exact": err == 0,
                                  "host_edge_ok": sem, "n_checked": m + 3}
        log(f"[kernels] horner_{g}: {m} + 3 MSMs of 16 and 4 windows, c = "
            f"16, max |kernel - plain| = {err}, edge MSMs vs host curve "
            f"{'ok' if sem else 'FAIL'}")

        # -- the bucket scan -------------------------------------------------
        # random tables of n_rand + 37 points (the last chunk runs past n):
        # Z in {0, one} for the mixed add, any Z (or 0) for the add; digits
        # over 2^16 buckets (runs of one or two) and over 16 (runs across
        # chunks), sorted as the MSM sorts them
        nr = n_rand + 37
        zm = torch.from_numpy(rng.random(nr) < 1 / 16).to(dev)
        tab_aff = jac.JPoint(rnd((nr,)), rnd((nr,)), ops.select(
            zm, ops.zero((nr,), dev), ops.one((nr,), dev)))
        tab_any = tab_aff._replace(z=ops.select(
            zm, ops.zero((nr,), dev), rnd((nr,))))
        err = 0
        for nb, w in ((1 << 16, 2), (16, 3)):
            d_sorted, order = torch.sort(torch.from_numpy(
                rng.integers(0, nb, size=(w, nr))).to(dev), dim=1)
            for aff, tab in ((True, tab_aff), (False, tab_any)):
                args = (ops, tab, order, d_sorted, nb, 64, aff)
                got = ck.bucket_scan(*args)
                want = ck.bucket_scan_plain(*args)
                torch.cuda.synchronize()
                err = max(err, bucket_err(got, want))
        # the edge table (229 real points, 2 windows, 16 buckets): see
        # edge_bucket_case
        host, tab, order, d_sorted = edge_bucket_case(
            ops, g, pts, hadd, hneg, A, B, C, D, rng)
        args = (ops, tab, order.to(dev), d_sorted.to(dev), 16, 64, True)
        got = ck.bucket_scan(*args)
        err = max(err, bucket_err(got, ck.bucket_scan_plain(*args)))
        sem = bucket_host_ok(ops, got, host, order, d_sorted, 16, 64, hadd)
        results[f"bucket_scan_{g}"] = {
            "max_abs_err": err, "bit_exact": err == 0, "host_edge_ok": sem,
            "n_checked": 4 * 5 * nr + 2 * 229}
        log(f"[kernels] bucket_scan_{g}: tables of {nr} points, 2^16 and "
            f"16 buckets, mixed and general adds, max |kernel - plain| = "
            f"{err}, edge table vs host curve {'ok' if sem else 'FAIL'}")

    # -- the NTT passes ------------------------------------------------------
    from zksnark_tpu_torch.ops import ntt

    err = 0
    for log_n in range(1, NTT_LOG_N + 1):
        d = ntt.get_domain(log_n, dev)
        n = 1 << log_n
        x = torch.from_numpy(FR_CTX.to_limbs_np(np.concatenate(
            [[0, 1, FR_CTX.p - 1, FR_CTX.r_int],
             rand_field(rng, FR_CTX.p, (min(n, n_rand),))])[:n])).to(dev)
        x = x.repeat(-(-n // x.shape[0]), 1)[:n].contiguous()
        uneven = (1,) + ntt.pass_widths(log_n - 1) if log_n > 1 else (1,)
        for tw in (d.t.tw_table, d.t.tw_table_inv):
            for widths in (d.widths, uneven):
                got = ntt.butterflies(FR_CTX, log_n, tw, x, widths)
                want = ntt.butterflies_plain(FR_CTX, log_n, tw, x, widths)
                torch.cuda.synchronize()
                err = max(err, limb_err(got, want))
    d = ntt.get_domain(5, dev)
    vals = [hrng.randrange(FR_CTX.p) for _ in range(29)] + [
        0, 1, FR_CTX.p - 1]
    got = FR_CTX.from_mont_np(ntt.ntt(d, torch.from_numpy(
        FR_CTX.to_mont_np(vals)).to(dev)).cpu().numpy())
    sem = [int(v) for v in got] == [
        sum(v * pow(d.omega, i * j, FR_CTX.p) for j, v in enumerate(vals))
        % FR_CTX.p for i in range(32)]
    results["ntt_fr"] = {"max_abs_err": err, "bit_exact": err == 0,
                         "host_edge_ok": sem,
                         "n_checked": 4 * (2 ** (NTT_LOG_N + 1) - 2)}
    log(f"[kernels] ntt_fr: log_n 1..{NTT_LOG_N}, forward and inverse, "
        f"default and uneven passes, max |kernel - plain| = {err}; 2^5 vs "
        f"host DFT {'ok' if sem else 'FAIL'}")


def bucket_err(got, want) -> int:
    """Largest difference between two bucket scans' outputs (slots,
    bucket_chunk, valid, totals)."""
    (gs, gc, gv, gt), (ws, wc, wv, wt) = got, want
    errs = [limb_err(a, b) for a, b in zip(list(gs) + list(gt),
                                             list(ws) + list(wt))]
    errs.append(int((gc - wc).abs().max().item()))
    errs.append(int((gv != wv).sum().item()))
    return max(errs)


def edge_bucket_case(ops, g, pts, hadd, hneg, A, B, C, D, rng):
    """229 real points (host list, None at infinity) and two windows of
    16-bucket digits: window 0 opens with (A, -A) in bucket 0 (madd's
    cancel branch) and (B, B, B) in bucket 1 (its doubling branch), leaves
    buckets 3, 8 and 14 empty; window 1 puts all but five points in bucket
    15.  Rows 5 and 6 are infinity, row 6 with C's X and Y.  Returns
    (host, table, order, d_sorted), the last two on the CPU."""
    n = 229
    host = [A, hneg(A), B, B, B, None, None]
    cur = D
    while len(host) < n:
        host.append(cur)
        cur = hadd(cur, C)
    tab = pts(host)
    xy = pts([C])
    tab.x[6], tab.y[6] = xy.x[0], xy.y[0]
    d = np.empty((2, n), dtype=np.int64)
    d[0] = rng.choice(np.setdiff1d(np.arange(2, 16), [3, 8, 14]), size=n)
    d[0, :2], d[0, 2:5] = 0, 1
    d[1] = 15
    d[1, rng.choice(n, size=5, replace=False)] = rng.integers(0, 16, 5)
    d_sorted, order = torch.sort(torch.from_numpy(d), dim=1, stable=True)
    return host, tab, order, d_sorted


def bucket_host_ok(ops, got, host, order, d_sorted, nb, c, hadd) -> bool:
    """The bucket scan's outputs against the host curve: slot (w, d) is
    its chunk's running sum at the end of digit d's run, bucket_chunk
    that chunk, valid whether d occurs; totals each chunk's sum."""
    from zksnark_tpu_torch.curve import jacobian as jac

    slots, chunk, valid, totals = got
    W, n = order.shape
    b = -(-n // c)
    ok = True
    for w in range(W):
        want = [None] * nb
        want_c, want_v = [0] * nb, [False] * nb
        for k in range(b):
            acc = None
            for pos in range(k * c, min(n, k * c + c)):
                acc = hadd(acc, host[int(order[w, pos])])
                dig = int(d_sorted[w, pos])
                if pos == n - 1 or dig != int(d_sorted[w, pos + 1]):
                    want[dig], want_c[dig], want_v[dig] = acc, k, True
            ok &= jac.to_affine_np(ops, jac.JPoint(
                *(a[k, w] for a in totals))) == acc
        ok &= list(jac.to_affine_np(ops, jac.JPoint(
            *(a[w] for a in slots)))) == want
        ok &= chunk[w].tolist() == want_c and valid[w].tolist() == want_v
    return bool(ok)


def time_phase(dev, seed: int, results: dict) -> None:
    """Each kernel and its plain version at the main path's shapes: both
    timed, and their outputs compared (`path_shape_err`)."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.field.limb import FQ_CTX, FR_CTX
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import montmul as mm

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(n, ctx, elem=()):
        # random limbs below p: clear the top limb's high bits
        t = torch.randint(-(1 << 31), 1 << 31, (n,) + elem + (8,),
                          dtype=torch.int64, device=dev, generator=gen)
        t[..., 7] &= 0x0FFFFFFF
        return t.to(torch.int32)

    shapes = PATH_SHAPES
    for ctx, name in ((FR_CTX, "montmul_fr"), (FQ_CTX, "montmul_fq")):
        n = shapes[name]
        a, b = rnd(n, ctx), rnd(n, ctx)
        ms, got = time_cuda(lambda: mm.mont_mul_cuda(ctx, a, b), 50)
        plain_ms, want = time_cuda(lambda: mm.mont_mul_plain(ctx, a, b), 3)
        err = limb_err(got, want)
        checked = [n]
        if ctx is FR_CTX:
            # and the witness x R^2 of a prove: 2^20 products with one
            # broadcast constant
            w = rnd(1 << 20, ctx)
            r2 = ctx.const("r2", dev)
            err = max(err, limb_err(mm.mont_mul_cuda(ctx, w, r2),
                                    mm.mont_mul_plain(ctx, w, r2)))
            checked.append(w.shape[0])
        byt = 3 * 32 * n
        ops_n = IMAD_PER_MUL * n
        results[name].update(shape=[n], ms=ms, plain_ms=plain_ms,
                             path_shape_err=err, checked_shapes=checked,
                             **bound(byt, ops_n))
        log(f"[timing] {name} n={n}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {results[name]['bound_ms']:.4f} ms "
            f"({results[name]['bound_by']}); max |kernel - plain| at "
            f"n={checked} = {err}")

    for ops, g in ((FQ_OPS, "g1"), (FQ2_OPS, "g2")):
        elem = () if g == "g1" else (2,)
        for op in ("madd", "add", "double"):
            name = f"{op}_{g}"
            n = shapes[op]
            P = jac.JPoint(rnd(n, FQ_CTX, elem), rnd(n, FQ_CTX, elem),
                           rnd(n, FQ_CTX, elem))
            Q = jac.JPoint(rnd(n, FQ_CTX, elem), rnd(n, FQ_CTX, elem),
                           ops.one((n,), dev).contiguous())
            kern = getattr(ck, op)
            plain = getattr(ck, f"{op}_plain")
            args = (P,) if op == "double" else (P, Q)
            ms, got = time_cuda(lambda: kern(ops, *args), 20)
            plain_ms, want = time_cuda(lambda: plain(ops, *args), 2)
            err = max(limb_err(a, b) for a, b in zip(got, want))
            del got, want
            cnt = CountingOps(ops)
            plain(cnt, *(jac.JPoint(*(c[:1] for c in a)) for a in args))
            elem_b = 32 * (1 if g == "g1" else 2)
            byt = elem_b * 3 * (len(args) + 1) * n
            ops_n = (cnt.muls * IMAD_PER_MUL + cnt.adds * OPS_PER_ADD) * n
            results[name].update(shape=[n], ms=ms, plain_ms=plain_ms,
                                 path_shape_err=err, checked_shapes=[n],
                                 fq_muls=cnt.muls, fq_adds=cnt.adds,
                                 **bound(byt, ops_n))
            log(f"[timing] {name} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {results[name]['bound_ms']:.5f} "
                f"ms ({results[name]['bound_by']}; {cnt.muls} Fq muls, "
                f"{cnt.adds} Fq adds per point); max |kernel - plain| = "
                f"{err}")
            if op == "add":
                # the add's other shapes on the path, kernel and plain
                per_shape = [{"shape": [n], "ms": ms, "plain_ms": plain_ms,
                              "err": err, **bound(byt, ops_n)}]
                for m in ADD_SHAPES[1:]:
                    a2 = [jac.JPoint(*(c[:m] for c in a)) for a in args]
                    m_ms, got = time_cuda(lambda: kern(ops, *a2), 20)
                    m_plain, want = time_cuda(lambda: plain(ops, *a2), 2)
                    m_err = max(limb_err(a, b) for a, b in zip(got, want))
                    per_shape.append({
                        "shape": [m], "ms": m_ms, "plain_ms": m_plain,
                        "err": m_err, **bound(byt * m // n, ops_n * m // n)})
                    log(f"[timing] {name} n={m}: kernel {m_ms:.4f} ms, "
                        f"plain {m_plain:.3f} ms, bound "
                        f"{per_shape[-1]['bound_ms']:.5f} ms; max |kernel "
                        f"- plain| = {m_err}")
                results[name].update(
                    per_shape=per_shape, checked_shapes=ADD_SHAPES,
                    path_shape_err=max(p["err"] for p in per_shape))

        chain_timing(ops, g, lambda n: jac.JPoint(
            rnd(n, FQ_CTX, elem), rnd(n, FQ_CTX, elem),
            rnd(n, FQ_CTX, elem)), results)
        bucket_timing(ops, g, lambda n: rnd(n, FQ_CTX, elem), gen, results)
    ntt_timing(rnd(1 << NTT_LOG_N, FR_CTX), results)


# shapes: montmul_fr at the prove's elementwise products (n^-1, coset,
# vanishing, from_mont: 2^20; the NTT stages' 2^19 now run inside the NTT
# kernel); montmul_fq at a batch_normalize prefix-product step (2^20 /
# 64); madd at setup's comb encryption (2^20 scalars, one madd per 8-bit
# digit; the MSM's scan steps now run inside the bucket scan); add at the
# MSM bucket ends (16 windows x 2^16 buckets); double at the former Abel
# step (one point per window)
PATH_SHAPES = {"montmul_fr": 1 << 20, "montmul_fq": 1 << 14,
               "madd": 1 << 20, "add": 1 << 20, "double": 16}
# the elementwise add's shapes in one 2^20 MSM (c = 16): bucket ends,
# the two chunk-carry fix-ups, the small Hillis-Steele rounds, E_top and
# the Abel subtraction (2^20, 2^18, 4096, 64 twice, 16 twice)
ADD_SHAPES = [1 << 20, 1 << 18, 4096, 64, 16]
# the chains at the shapes of one 2^20 MSM (c = 16: W = 16 windows, 2^14
# chunks of 64 sorted points per window): (chunks, steps, lanes per chunk,
# collect) of the two chunk-carry scans and the three tree-sum levels
SCAN_SHAPES = [(256, 64, 16, True), (4, 64, 16, True), (1024, 64, 16, False),
               (16, 64, 16, False), (1, 16, 16, False)]
DOUBLE_N_SHAPE = (16, 16)        # Abel: 2^16 E_top, one point per window
# Horner: W windows, c doublings each, MSMs side by side (a prove's four
# G1 MSMs share one launch; its G2 MSM has its own)
HORNER_SHAPE = {"g1": (16, 16, 4), "g2": (16, 16, 1)}


def loop_add_scan(ops, grid, collect):
    """What add_scan replaced (the MSM's _scan_chunks before it): a
    transposed (c, B, ...) copy, then one elementwise add launch per
    step, each writing its prefix in place."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck

    g = jac.JPoint(*(a.transpose(0, 1).contiguous() for a in grid))
    acc = jac.infinity(ops, g.z.shape[1:g.z.dim() - ops.elem_ndim],
                       g.z.device)
    within = jac.JPoint(*(torch.empty_like(a) for a in g)) if collect \
        else None
    for j in range(g.z.shape[0]):
        out = jac.JPoint(*(a[j] for a in within)) if collect else None
        acc = ck.add(ops, acc, jac.JPoint(*(a[j] for a in g)), out=out)
    return acc, within


# the bucket scan at one 2^20 MSM's shape: W windows of c-bit digits
BUCKET_SHAPE = {"windows": 16, "c": 16, "n": 1 << 20}
NTT_LOG_N = 20                   # the prove's transforms; checked 1 .. 20


def loop_bucket_scan(ops, pts, order, d_sorted, num_buckets, affine):
    """What bucket_scan replaced (`ops/msm.py` before it): the sorted
    points gathered into a (64, B, W) grid, one elementwise madd (or add)
    launch per step writing its prefix into `within`, the permute of
    `within` to (W, N), and the scatter of the run ends into bucket slots
    by index_copy and index_fill.  Returns what bucket_scan returns."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import msm

    W, n = order.shape
    dev = pts.z.device
    elem = pts.x.shape[1:]
    comb = jac.madd if affine else jac.add
    cdim = min(64, n)
    b = -(-n // cdim)
    pts_ext = msm._pad_to(ops, pts, n + 1)
    idx = torch.cat([order, order.new_full((W, b * cdim - n), n)], dim=1)
    idx = idx.reshape(W, b, cdim).permute(2, 1, 0).contiguous()
    grid = msm._index(pts_ext, idx)                           # (cdim, B, W)
    within = jac.JPoint(*(torch.empty_like(a) for a in grid))
    acc = jac.infinity(ops, (b, W), dev)
    for j in range(cdim):
        acc = comb(ops, acc, msm._index(grid, j),
                   out=msm._index(within, j))
    del grid
    flat_w = jac.JPoint(*(a.permute(2, 1, 0, *range(3, a.dim()))
                          .reshape((W, b * cdim) + elem)[:, :n]
                          for a in within))
    del within
    nxt = torch.cat([d_sorted[:, 1:],
                     d_sorted.new_full((W, 1), num_buckets)], dim=1)
    tgt = torch.where(d_sorted != nxt, d_sorted,
                      d_sorted.new_full((), num_buckets))
    rows = (tgt + torch.arange(W, device=dev).unsqueeze(1)
            * (num_buckets + 1)).reshape(-1)
    inf_b = jac.infinity(ops, (W * (num_buckets + 1),), dev)
    slots = msm._pack(inf_b, (W * (num_buckets + 1),)).index_copy(
        0, rows, msm._pack(flat_w, (W * n,)))
    slots = msm._unpack(
        slots.reshape(W, num_buckets + 1, -1)[:, :num_buckets], elem)
    pos_chunk = (torch.arange(n, device=dev) // cdim).repeat(W)
    chunk = torch.zeros(W * (num_buckets + 1), dtype=torch.int64,
                        device=dev).index_copy(0, rows, pos_chunk)
    valid = torch.zeros(W * (num_buckets + 1), dtype=torch.bool,
                        device=dev).index_fill(0, rows, True)
    return (slots, chunk.reshape(W, -1)[:, :num_buckets],
            valid.reshape(W, -1)[:, :num_buckets], acc)


def loop_ntt(domain, x):
    """What the NTT kernel replaced (`ops/ntt.py` before it): the
    bit-reversal gather, then per stage one K1 launch for the twiddle
    products, the plain add and subtract, and a cat."""
    from zksnark_tpu_torch.field.limb import add, sub
    from zksnark_tpu_torch.ops import montmul as mm
    from zksnark_tpu_torch.ops import ntt

    ctx, log_n = domain.ctx, domain.log_n
    n = 1 << log_n
    x = x[ntt._bitrev(log_n, x.device)]
    for s in range(1, log_n + 1):
        half, m = 1 << (s - 1), 1 << s
        xb = x.reshape(n // m, m, 8)
        u, v = xb[:, :half], xb[:, half:]
        w = domain.t.tw_table[0:n // 2:n // m]
        t = mm.mont_mul(ctx, w.unsqueeze(0), v)
        x = torch.cat([add(ctx, u, t), sub(ctx, u, t)], dim=1).reshape(n, 8)
    return x


def bucket_timing(ops, g, rnd_elem, gen, results) -> None:
    """The bucket scan of one 2^20 MSM (W = 16 windows of 16-bit digits,
    sorted as the MSM sorts them, over an affine table with a point at
    infinity 1 time in 16): the kernel, its plain version and the loop it
    replaced, on the same inputs, timed and compared."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck

    W, c, n = (BUCKET_SHAPE[k] for k in ("windows", "c", "n"))
    nb = 1 << c
    dev = gen.device
    zm = torch.randint(0, 16, (n,), device=dev, generator=gen) == 0
    tab = jac.JPoint(rnd_elem(n), rnd_elem(n), ops.select(
        zm, ops.zero((n,), dev), ops.one((n,), dev)).contiguous())
    d_sorted, order = torch.sort(torch.randint(
        0, nb, (W, n), device=dev, generator=gen), dim=1)
    args = (ops, tab, order, d_sorted, nb, 64, True)
    ms, got = time_cuda(lambda: ck.bucket_scan(*args), 5)
    loop_ms, old = time_cuda(
        lambda: loop_bucket_scan(ops, tab, order, d_sorted, nb, True), 2)
    plain_ms, want = time_cuda(lambda: ck.bucket_scan_plain(*args), 1)
    err = max(bucket_err(got, want), bucket_err(old, want))
    del got, old, want
    cnt = CountingOps(ops)
    ck.madd_plain(cnt, *(jac.JPoint(*(a[i:i + 1] for a in tab))
                         for i in (0, 1)))
    elem_b = 32 * (1 if g == "g1" else 2)
    b = n // 64
    byt = (3 * elem_b * n + 2 * 8 * W * n + W * nb * (3 * elem_b + 9)
           + 3 * elem_b * b * W)
    bnd = bound(byt, W * n * (cnt.muls * IMAD_PER_MUL
                              + cnt.adds * OPS_PER_ADD))
    name = f"bucket_scan_{g}"
    results[name].update(shape=[W, c, n], ms=ms, loop_ms=loop_ms,
                         plain_ms=plain_ms, path_shape_err=err,
                         checked_shapes=[[W, c, n]], **bnd)
    log(f"[timing] {name} W={W} c={c} n={n}: kernel {ms:.4f} ms, loop of "
        f"launches {loop_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); max |kernel - "
        f"plain|, |loop - plain| = {err}")


def ntt_timing(x, results) -> None:
    """One 2^20 transform (the prove's size): the kernel's passes, its
    plain version and the per-stage loop it replaced, on the same input,
    timed and compared."""
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.ops import ntt

    log_n = NTT_LOG_N
    d = ntt.get_domain(log_n, x.device)
    tw = d.t.tw_table
    ms, got = time_cuda(lambda: ntt.ntt(d, x), 20)
    loop_ms, old = time_cuda(lambda: loop_ntt(d, x), 3)
    plain_ms, want = time_cuda(lambda: ntt.butterflies_plain(
        FR_CTX, log_n, tw, x, d.widths), 1)
    err = max(limb_err(got, want), limb_err(old, want))
    n = 1 << log_n
    bnd = bound(32 * (2 * n + n // 2),
                log_n * (n // 2) * (IMAD_PER_MUL + 2 * OPS_PER_ADD))
    results["ntt_fr"].update(shape=[n], ms=ms, loop_ms=loop_ms,
                             plain_ms=plain_ms, path_shape_err=err,
                             checked_shapes=[n], widths=list(d.widths),
                             **bnd)
    log(f"[timing] ntt_fr n=2^{log_n} passes {d.widths}: kernel {ms:.4f} ms, "
        f"loop of stages {loop_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); max |kernel - "
        f"plain|, |loop - plain| = {err}")


def loop_double_n(ops, p, k):
    from zksnark_tpu_torch.ops import curve_kernels as ck

    for _ in range(k):
        p = ck.double(ops, p)
    return p


def loop_horner(ops, sums, c):
    """What horner replaced: per MSM (column of sums), c elementwise
    doubling launches and one add launch per window."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck

    outs = []
    for m in range(sums.z.shape[1]):
        acc = jac.infinity(ops, (), sums.z.device)
        for w in range(sums.z.shape[0] - 1, -1, -1):
            acc = loop_double_n(ops, acc, c)
            acc = ck.add(ops, acc, jac.JPoint(*(a[w, m] for a in sums)))
        outs.append(acc)
    return jac.JPoint(*(torch.stack(c) for c in zip(*outs)))


def chain_timing(ops, g, rnd_pts, results) -> None:
    """add_scan, double_n and horner at the path's shapes: each entry, its
    plain version and the loop of elementwise launches it replaced, all
    on the same inputs, timed and compared.  A row's ms / plain_ms /
    loop_ms / bound_ms are the sums over its shapes: one MSM's worth (for
    horner, one launch's: a prove's four G1 MSMs, or its G2 MSM)."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck

    elem_b = 32 * (1 if g == "g1" else 2)
    cnt_add, cnt_dbl = CountingOps(ops), CountingOps(ops)
    one = rnd_pts(1)
    ck.add_plain(cnt_add, one, rnd_pts(1))
    ck.double_plain(cnt_dbl, one)
    add_ops = cnt_add.muls * IMAD_PER_MUL + cnt_add.adds * OPS_PER_ADD
    dbl_ops = cnt_dbl.muls * IMAD_PER_MUL + cnt_dbl.adds * OPS_PER_ADD

    def err_of(a, b):
        return max(limb_err(u, v) for u, v in zip(a, b))

    def scan_case(b, c, r, collect):
        grid = jac.JPoint(*(a.reshape((b, c, r) + a.shape[1:])
                            for a in rnd_pts(b * c * r)))
        ms, got = time_cuda(lambda: ck.add_scan(ops, grid, collect), 10)
        loop_ms, old = time_cuda(lambda: loop_add_scan(ops, grid, collect), 3)
        plain_ms, want = time_cuda(
            lambda: ck.add_scan_plain(ops, grid, collect), 1)
        err = max(err_of(got[0], want[0]), err_of(old[0], want[0]))
        if collect:
            err = max(err, err_of(got[1], want[1]), err_of(
                [a.transpose(0, 1) for a in old[1]], want[1]))
        lanes = b * r
        byt = elem_b * 3 * (lanes * c + lanes + (lanes * c if collect else 0))
        return ([b, c, r, int(collect)], ms, loop_ms, plain_ms, err,
                bound(byt, lanes * c * add_ops))

    def double_n_case(n, k):
        p = rnd_pts(n)
        ms, got = time_cuda(lambda: ck.double_n(ops, p, k), 20)
        loop_ms, old = time_cuda(lambda: loop_double_n(ops, p, k), 3)
        plain_ms, want = time_cuda(lambda: ck.double_n_plain(ops, p, k), 1)
        err = max(err_of(got, want), err_of(old, want))
        return ([n, k], ms, loop_ms, plain_ms, err,
                bound(elem_b * 3 * 2 * n, n * k * dbl_ops))

    def horner_case(w, c, m):
        sums = jac.JPoint(*(a.reshape((w, m) + a.shape[1:])
                            for a in rnd_pts(w * m)))
        ms, got = time_cuda(lambda: ck.horner(ops, sums, c), 20)
        loop_ms, old = time_cuda(lambda: loop_horner(ops, sums, c), 3)
        plain_ms, want = time_cuda(lambda: ck.horner_plain(ops, sums, c), 1)
        err = max(err_of(got, want), err_of(old, want))
        return ([w, c, m], ms, loop_ms, plain_ms, err,
                bound(elem_b * 3 * (w + 1) * m,
                      m * w * (c * dbl_ops + add_ops)))

    # one thread's latency: 64 dependent adds (horner with c = 0 over 64
    # window sums of one MSM) and 64 dependent doublings (double_n of one
    # point): what bounds the small scans and the Horner tail
    sums64 = jac.JPoint(*(a.reshape((64, 1) + a.shape[1:])
                          for a in rnd_pts(64)))
    add_us = time_cuda(lambda: ck.horner(ops, sums64, 0), 5)[0] * 1e3 / 64
    one = rnd_pts(1)
    dbl_us = time_cuda(lambda: ck.double_n(ops, one, 64), 5)[0] * 1e3 / 64
    log(f"[timing] {g} one thread: {add_us:.2f} us per dependent add, "
        f"{dbl_us:.2f} us per dependent doubling")

    cases = {"add_scan": [scan_case(*s) for s in SCAN_SHAPES],
             "double_n": [double_n_case(*DOUBLE_N_SHAPE)],
             "horner": [horner_case(*HORNER_SHAPE[g])]}
    for op, rows in cases.items():
        name = f"{op}_{g}"
        per_shape = []
        for shape, ms, loop_ms, plain_ms, err, bnd in rows:
            per_shape.append({"shape": shape, "ms": ms, "loop_ms": loop_ms,
                              "plain_ms": plain_ms, "err": err, **bnd})
            log(f"[timing] {name} {shape}: kernel {ms:.4f} ms, loop of "
                f"launches {loop_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}); max |kernel "
                f"- plain|, |loop - plain| = {err}")
        tb = sum(p["bound_ms"] for p in per_shape)
        by = max(per_shape, key=lambda p: p["bound_ms"])["bound_by"]
        results[name].update(
            shape=[p["shape"] for p in per_shape],
            ms=sum(p["ms"] for p in per_shape),
            loop_ms=sum(p["loop_ms"] for p in per_shape),
            plain_ms=sum(p["plain_ms"] for p in per_shape),
            path_shape_err=max(p["err"] for p in per_shape),
            checked_shapes=[p["shape"] for p in per_shape],
            bound_ms=tb, bound_by=by, per_shape=per_shape,
            thread_add_us=add_us, thread_double_us=dbl_us)
        log(f"[timing] {name}, summed over its shapes: kernel "
            f"{results[name]['ms']:.4f} ms, loop of launches "
            f"{results[name]['loop_ms']:.3f} ms, bound {tb:.5f} ms")


def ptxas_summary(log_text: str) -> list:
    """One line per kernel from nvcc's `-Xptxas -v` output: the kernel
    (its name and template arguments read off the mangled name), its
    registers and its spills."""
    def kernel_name(mangled):
        # the length-prefixed identifier that ends in "kernel" (a length
        # may follow digits of the namespace's hash: try every split)
        for m in re.finditer(r"\d+", mangled):
            for i in range(m.start(), m.end()):
                size = int(mangled[i:m.end()])
                ident = mangled[m.end():m.end() + size]
                if len(ident) == size and ident.endswith("kernel"):
                    return ident
        return mangled

    out, name, spill = [], "?", ""
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            name = kernel_name(mangled)
            if "Fe2" in mangled:
                name += "<Fe2"
            elif "Fe" in mangled:
                name += "<Fe"
            if "Lb1" in mangled:
                name += ", mixed"
            name += ">" if "<" in name else ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used \d+ registers", line)
            out.append(f"{name}: {regs.group(0) if regs else line.strip()}"
                       f", {spill}")
    return out


def bound(nbytes: int, nops: int) -> dict:
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = nops / PEAK_IMAD_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# ---------------------------------------------------------------------------
# reference and path phases
# ---------------------------------------------------------------------------

def _counters() -> tuple:
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import montmul as mm
    from zksnark_tpu_torch.ops import ntt

    return mm.LAUNCHES, ntt.LAUNCHES, ck.LAUNCHES


def counts() -> dict:
    return {k: v for d in _counters() for k, v in d.items()}


def reset_counts() -> None:
    for d in _counters():
        for k in d:
            d[k] = 0


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def reference_phase(dev) -> None:
    """The same small circuit proved on the card and with the plain
    versions on the CPU: the proofs must be equal."""
    from zksnark_tpu_torch.groth16 import prover

    r1cs, wit = synthetic_square_chain((1 << 3) - 1)
    proofs = []
    for d in (dev, "cpu"):
        t0 = time.time()
        dq = prover.compile_r1cs(r1cs, device=d)
        crs = prover.device_setup(dq, trapdoor=(11, 22, 33, 44, 55))
        proofs.append(prover.device_prove(dq, crs, wit, blinding=(7, 9)))
        log(f"[reference] n=8 setup+prove on {d}: {time.time() - t0:.2f} s")
    if proofs[0] != proofs[1]:
        raise SystemExit("reference: the card's proof differs from the "
                         "plain CPU proof")
    log("[reference] card proof == plain CPU proof")


def path_phase(dev, log_n: int, n_proves: int) -> dict:
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.curve import bn254 as hc
    from zksnark_tpu_torch.field import params
    from zksnark_tpu_torch.groth16 import protocol, prover
    from zksnark_tpu_torch.groth16.backend import BN254Backend

    t0 = time.time()
    r1cs, wit = synthetic_square_chain((1 << log_n) - 1)
    log(f"[path] square chain, {len(wit)} wires (host): "
        f"{time.time() - t0:.2f} s")
    t0 = time.time()
    dqap = prover.compile_r1cs(r1cs, device=dev)
    torch.cuda.synchronize()
    log(f"[path] compile_r1cs n={dqap.n} (host ELL tables + domain): "
        f"{time.time() - t0:.2f} s")
    t0 = time.time()
    for ops, gen, scale in ((FQ_OPS, hc.G1_GEN_PT, params.ENCRYPT_G1_SCALE),
                            (FQ2_OPS, hc.G2_GEN, params.ENCRYPT_G2_SCALE)):
        smul = hc.g1_scalar_mul if ops is FQ_OPS else hc.g2_scalar_mul
        prover._comb_table(ops, smul(gen, scale), dqap.device)
    torch.cuda.synchronize()
    log(f"[path] comb tables (host point adds): {time.time() - t0:.2f} s")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    crs = prover.device_setup(dqap, trapdoor=(11, 22, 33, 44, 55))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    c_setup = counts()
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[path] device_setup: {setup_s:.2f} s; launches {c_setup}; peak "
        f"device memory {setup_peak:.2f} GiB")
    # per prove: the bucket scan once per MSM, no elementwise madd, the
    # NTT kernel once per pass of each of the seven transforms
    expect = {"bucket_scan_g1": 4, "bucket_scan_g2": 1, "madd_g1": 0,
              "madd_g2": 0, "ntt_fr": 7 * len(dqap.domain.widths)}

    be = BN254Backend()
    x = wit[1]
    per_prove = []
    prev = c_setup
    for i in range(n_proves):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof = prover.device_prove(dqap, crs, wit, blinding=(7 + i, 9 + i))
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        now = counts()
        launches = diff(now, prev)
        prev = now
        t1 = time.time()
        ok = protocol.verify(be, (crs.sigmag1, crs.sigmag2), [x], proof)
        bad = protocol.verify(be, (crs.sigmag1, crs.sigmag2), [x + 1], proof)
        vs = time.time() - t1
        k34 = sum(v for k, v in launches.items()
                  if k.split("_g")[0] in ("add", "double", "add_scan",
                                          "double_n", "horner"))
        log(f"[path] prove {i}: {ms:.1f} ms; launches {launches} (K3 + K4: "
            f"{k34}); peak device memory {peak:.2f} GiB; verify [x] {ok}, "
            f"[x+1] {bad} ({vs:.2f} s)")
        if not ok or bad:
            raise SystemExit(f"proof {i} failed verification "
                             f"(accept {ok}, tampered accept {bad})")
        wrong = {k: launches[k] for k, v in expect.items()
                 if launches[k] != v}
        if wrong:
            raise SystemExit(f"prove {i} launched {wrong}, expected "
                             f"{ {k: expect[k] for k in wrong} }")
        per_prove.append({"ms": ms, "launches": launches, "k3_k4": k34,
                          "peak_gib": peak})
    total = counts()
    peak = max([setup_peak] + [p["peak_gib"] for p in per_prove])
    log(f"[path] launches over setup + {n_proves} proves: {total}; peak "
        f"device memory {peak:.2f} GiB")
    zero = [k for k, v in total.items() if v == 0 and k not in OFF_PATH]
    if zero:
        raise SystemExit(f"kernels never launched on the main path: {zero}")
    return {"launches": total, "setup_s": setup_s, "proves": per_prove,
            "peak_gib": peak, "state": (dqap, crs, wit)}


def profile_phase(dqap, crs, wit, table_path: str) -> None:
    """Where a prove's time goes: its stages timed one by one (each ends
    in a synchronize), then one whole prove under torch.profiler (device
    time by kernel, and the device's idle share of the wall time).  The
    profiler's full table is written to `table_path`."""
    from torch.profiler import ProfilerActivity, profile

    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import msm

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        log(f"[profile] {label}: {(time.time() - t0) * 1e3:.1f} ms")
        return out

    dev = dqap.device
    w_std = timed("witness to limbs (host)", lambda: torch.from_numpy(
        FR_CTX.to_limbs_np(wit)).to(dev))
    wm = timed("witness x R^2", lambda: prover.mont_mul(
        FR_CTX, w_std, FR_CTX.const("r2", dev)))
    ells = (dqap.u, dqap.v, dqap.w)
    u, v, h, tail = timed("quotient (ELL, 3 iNTT, 3 coset NTT, coset "
                          "iNTT)", lambda: prover._witness_quotient(
                              dqap.domain, dqap.input, ells, wm))
    n = dqap.n
    m = max(n, crs.sum_delta_g1.z.shape[0], tail.shape[0])
    wb = msm.pick_window_bits(n)
    jobs = [("msm G1 A (u)", crs.xi_g1, u), ("msm G1 B (v)", crs.xi_g1, v),
            ("msm G1 H (h)", crs.xi_t_g1, h[:n - 1]),
            ("msm G1 C (witness)", crs.sum_delta_g1, tail)]
    for label, pts, sc in jobs:
        pp, ss = prover._pad_msm(FQ_OPS, pts, sc, m)
        timed(label, lambda: msm.msm_windowed(FQ_OPS, pp, ss, wb, True))
    timed("msm G2 B (v)", lambda: msm.msm_windowed(FQ2_OPS, crs.xi_g2, v,
                                                    wb, True))

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        prover.device_prove(dqap, crs, wit, blinding=(5, 6))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device activities only; "Command Buffer Full" is CUPTI's record of
    # the host waiting for a full launch queue, not device work
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and not e.key.startswith("Command Buffer Full")]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[profile] one prove under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))


def main(argv=None) -> int:
    log_n, n_proves = 20, 3
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TABLE",
                    help="after the path, break one prove down by stage "
                    "and by kernel (torch.profiler) and write the "
                    "profiler's table to TABLE")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from zksnark_tpu_torch import _build

    dev = torch.device("cuda")
    card = gpu_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.time()
    _build.build()
    log(f"[build] kernels built in {time.time() - t0:.1f} s (nvcc "
        f"{_build.build_seconds:.1f} s)")
    for src in _build.SOURCES:
        for line in ptxas_summary(_build.build_log(src)):
            log(f"[build] {src}: {line}")

    results: dict = {}
    with torch.inference_mode():
        kernel_phase(dev, SEED, 1 << 16, results)
        bad = [k for k, r in results.items()
               if not (r["bit_exact"] and r["host_edge_ok"])]
        if bad:
            raise SystemExit(f"kernels disagree: {bad}")
        time_phase(dev, SEED, results)
        bad = [k for k, r in results.items() if r["path_shape_err"] != 0]
        if bad:
            raise SystemExit(f"kernels disagree at the path's shapes: {bad}")
    reference_phase(dev)
    path = path_phase(dev, log_n, n_proves)
    if args.profile:
        profile_phase(*path["state"], args.profile)

    kernels = []
    for name, r in results.items():
        op = name.rsplit("_", 1)[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[op],
            "replaces": TPU_KERNELS[op],
            "launches": path["launches"][name],
            "max_abs_err": max(r["max_abs_err"], r["path_shape_err"]),
            "path_shape_err": r["path_shape_err"],
            "checked_shapes": r["checked_shapes"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"],
            "launches_per_prove": path["proves"][-1]["launches"][name],
            **({"loop_ms": r["loop_ms"]} if "loop_ms" in r else {}),
        })
    log(f"[path] n=2^{log_n}: setup {path['setup_s']:.2f} s, prove "
        f"ms {[round(p['ms'], 1) for p in path['proves']]}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
