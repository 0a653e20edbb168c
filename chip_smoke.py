#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`zksnark_tpu_torch`) on one card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --profile TABLE  # and one 2^20 prove broken down

Phases, each of which must pass (the script exits non-zero otherwise):

1. build: `nvcc` compiles every kernel source under
   `zksnark_tpu_torch/csrc/` (one process per source, in parallel).
2. kernels: each kernel entry — K1 montmul (Fr, Fq); K2 madd, K3 add,
   K4 double (G1, G2); the MSM's chains K2 bucket_scan, K3 add_scan, K4
   double_n and horner (G1, G2); the MSM's tail K3 block_scan,
   add_gather and K4 abel (G1, G2); the NTT passes; setup's K1 mont_scan
   and normalize (Fq, Fq2: batch_normalize's prefix products and its
   pass over the points) and its chain K2 comb (G1, G2: the fixed-base
   comb encryption) — runs on 2^16 random inputs plus the edge cases
   (0, 1, p-1; P = Q, P = -Q, P = inf,
   Q = inf, a malformed Z; for the chains a step at infinity, a step
   equal to the accumulator, a step equal to its negation, a lane all at
   infinity, k = 0 and 1, window sums at infinity; for the bucket scan a
   bucket whose points cancel, a bucket of equal points, infinity table
   entries, empty buckets, runs across chunks and an n that is not a
   multiple of 64, mixed and general adds; for add_gather an index < 0
   on either side and on both, P = Q met only through the gather, P = -Q,
   infinity rows, one table on both sides, the bucket ends of a scan
   whose window opens with empty buckets; for abel an infinite E_top, R
   at infinity, R = +-2^k E_top, k = 0, 1, 16; for the NTT every log_n from 1
   to 20, forward and inverse, in the default passes and in an uneven
   split; for the scan rows of one element, zero elements and carries,
   a carry of one; for normalize a point alone and real points with
   other Z and infinities; for the comb the scalars 0, 1, r - 1,
   2^256 - 1 and ones with zero bytes, the table read both ways) and
   must equal its plain PyTorch version on the same CUDA inputs bit for
   bit; the edge cases built from real curve points (and
   a small NTT against the host DFT) must also equal the host
   arithmetic.  Each entry and its plain version then run on the same
   random CUDA inputs at the shapes the main path gives it: the two
   outputs must again be equal bit for bit, and both are timed with CUDA
   events: the chains, the bucket scan (a 2^20 prove's: one and two
   windows over window tables of 16 (2^20 + 3) rows, G1, and one over
   16 (2^20 + 2), G2; and the windowed formulation's 16 windows over
   2^20 points), the NTT, the scan (every level of a 2^20 prefix
   product, and the whole product against itself on the plain scan),
   normalize (2^20 points), the comb (2^20 scalars, G1 and G2) and the
   MSM's tail (a 2^20 and a 2^18 prove's, the G1 MSMs' one tail over 4
   columns and the G2 MSM's over 1: the bucket ends of a real bucket
   scan of the tables' rows, every level of the block scans of the
   chunk carries and of the tree sum, the carries' fix-ups, Abel; and
   the windowed formulation's at one 2^20 MSM over 16 columns; with the
   profiler's device time at the small shapes).  The G1 bucket scan is
   also checked at the keccak path's C MSM digits on its table (16
   blocks of 2^18 + 3 rows, block 0 in {0, 1}, blocks 1-15 all 0).
3. reference: a small circuit (n = 2^3) proves on the card and with the
   plain versions on the CPU; the two proofs must be equal.
4. path: the main path at full size — the square-chain circuit with
   n = 2^20 gates, `compile_r1cs`, `device_setup`, then three
   `device_prove` calls with distinct blindings; each proof must verify
   on its public input x and be rejected on x + 1.  The kernel launch
   counts are reset just before setup and read after it and after each
   prove; every kernel entry of the path must have launched (all but the
   elementwise double, madd, add and Fq product, whose work now runs in
   the bucket scan, add_gather, abel, the comb, mont_scan and normalize,
   horner and the batched NTT, which only the mesh path runs, and
   double_n, which only setup's window tables run); setup
   (`setup_expect`) must launch the comb and normalize once per point
   set (three G1, one G2), the scan `scan_launches(n)` times for each of
   a set's two prefix products, then for the prove sets' window tables
   double_n W - 1 times a group and one more batch_normalize a set, and
   the elementwise madd and Fq product not at all; each prove
   (`prove_expect`) must launch the bucket scan once a table (three G1,
   one G2), block_scan and add_gather as `tail_launches` says for the
   four G1 MSMs' one tail and the G2 MSM's, abel once a tail, horner,
   the elementwise madd, add and double_n and add_scan not at all, and
   the NTT kernel once per pass of its seven transforms.  The prove's
   MSMs over the window tables (`_prove_core`) must then give the
   windowed formulation's five points, in affine form, on the same sets
   and scalars (both timed, in turns).  A second setup is then timed
   phase by phase (scalars, host sigma points, comb, normalize, tables)
   and must make the same CRS.
5. keccak: the example `zksnark_tpu_torch.examples.keccak_proof` at full
   size (4-byte preimage, 232,016 gates, n = 2^18, 288 public inputs):
   its host stages timed, setup, two proves with distinct blindings,
   each verified on the digest bits and zero checkers and rejected with
   a digest bit flipped; counts reset before setup, the same setup and
   per-prove launches required, every kernel entry but the elementwise
   double, madd and Fq product launched.
6. cli: `python -m zksnark_tpu_torch.cli` setup -> prove -> verify on
   `simple.zk`, one process per command (exit 0 each), and verify with a
   wrong public input (exit 1); setup and prove together must launch
   every kernel entry but the elementwise double, madd and Fq
   product.  The same four steps
   through the host flow (`--backend host`), over BN254 and over Z251,
   with the same exits, and `bench --backend host` (exit 0, one JSON
   report).
7. host: on `simple.zk`, the card's `device_setup` + `device_prove`
   against the port's host `protocol.setup` + `prove` over the same
   domain roots, trapdoor and blinding: the same proof JSON text, the
   same CRS (its host parts, which check the 69 G1 / 96 G2 generator
   scales, and its point sets), both proofs verified on [2, 34] and
   rejected on [2, 35]; the Z251 mock backend accepts and rejects the
   same way.
8. field: `mont_inv` (Fr, Fq) on 2^16 random elements plus 0, 1 and
   p - 1, bit-exact against its plain version on the card and equal to
   pow(x, p - 2, p) on the host, zero to zero.
9. poly_mul: at n = 2^20 (degrees < 2^19) bit-exact against its plain
   version on the card; at n = 2^10 equal to the host `dense.mul`.
10. msm_bits: `msm(..., scalar_bits=64)` over the path's 2^20 G1 CRS
   points equal to the full MSM in affine form, with one bucket-scan
   launch at W = 4 windows (and the tail's add_gathers and one abel),
   and bit-exact against its plain version on
   the card at the same shape (c = 16, W = 4).
11. bench: `python -m zksnark_tpu_torch.bench --log-n 20 --repeats 2` in
   its own process; its headline must parse, with a value > 0 and the
   proof verified.
12. mesh: the mesh path (`device_setup(mesh=)`, `device_prove(mesh=)`:
   the four-step quotient on the batched NTT pass, point-sharded MSMs),
   each rank a child process on the card: NCCL at world size 1 with n =
   2^20, then gloo at world sizes 2 and 4 with every rank on cuda:0 and
   n = 2^18.  Each run: setup, then two proves with the blindings of
   `[path]`; every rank's proofs must be byte-equal (`proof_to_json`) to
   the single-device proofs with the same trapdoor and blindings (those
   of `[path]` at 2^20, two more made here at 2^18), verify on [x] and
   be rejected on [x + 1]; each prove must launch the batched NTT once
   per pass of its seven four-step transforms (both halves), the bucket
   scan once per MSM, block_scan and add_gather as `tail_launches` says
   per MSM over a rank's n / world points, 3 more in A's and C's, 2 more
   in B's (the blinding's), with one block scan more per MSM where ranks'
   partial sums are summed, and abel once per MSM, and no
   single-transform NTT or elementwise madd, add, double_n or add_scan,
   and setup and the proves together every kernel entry of the mesh
   path (all but the elementwise double, madd, add, double_n and Fq
   product and the single-transform NTT).
   The batched NTT pass is also checked in phase 2: small batches of
   every log_n from 1 to 12 and the path's four-step batches, forward
   and inverse, bit-exact against its plain version and against the
   same transforms launched one at a time; and timed at the path's
   batches.
Each of phases 5-12 resets the kernel launch counts just before what it
drives and reads them just after (a process's own counts for the CLI,
the bench and each rank); the kernels' JSON line gives them by path.

The last lines are the kernels' JSON summary, the card's name and power
limit (nvidia-smi), and {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# the card's peaks and the multiply-adds of a Montgomery product, as the
# benchmark's roofline shares take them
from benchmark.peaks import (  # noqa: E402
    HBM_BYTES_PER_S, INT32_MULADD_PER_S, MULADDS_PER_MONT_MUL)

SEED = 20261016                  # of every random input
# 32-bit add/sub instructions per modular add or sub (8-word chain plus the
# 8-word conditional subtract)
OPS_PER_ADD = 16

TPU_KERNELS = {
    "montmul": "zksnark_tpu/ops/montmul.py:42",
    "montmul_add": "zksnark_tpu/ops/montmul.py:42",
    "wide_rows": "zksnark_tpu/ops/montmul.py:42",
    "ntt": "zksnark_tpu/ops/montmul.py:42",
    "madd": "zksnark_tpu/ops/curve_pallas.py:291",
    "bucket_scan": "zksnark_tpu/ops/curve_pallas.py:291",
    "add": "zksnark_tpu/ops/curve_pallas.py:281",
    "double": "zksnark_tpu/ops/curve_pallas.py:301",
    "add_scan": "zksnark_tpu/ops/curve_pallas.py:281",
    "double_n": "zksnark_tpu/ops/curve_pallas.py:301",
    "horner": "zksnark_tpu/ops/curve_pallas.py:301",
    "mont_scan": "zksnark_tpu/ops/montmul.py:42",
    "normalize": "zksnark_tpu/ops/montmul.py:42",
    "comb": "zksnark_tpu/ops/curve_pallas.py:291",
    "add_gather": "zksnark_tpu/ops/curve_pallas.py:281",
    "abel": "zksnark_tpu/ops/curve_pallas.py:301",
    "block_scan": "zksnark_tpu/ops/curve_pallas.py:281",
}
SOURCES = {
    "montmul": "zksnark_tpu_torch/csrc/montmul.cu",
    "montmul_add": "zksnark_tpu_torch/csrc/montmul.cu",
    "wide_rows": "zksnark_tpu_torch/csrc/montmul.cu",
    "ntt": "zksnark_tpu_torch/csrc/ntt.cu",
    "madd": "zksnark_tpu_torch/csrc/point_ops.cu",
    "bucket_scan": "zksnark_tpu_torch/csrc/point_scan.cu",
    "add": "zksnark_tpu_torch/csrc/point_ops.cu",
    "double": "zksnark_tpu_torch/csrc/point_ops.cu",
    "add_scan": "zksnark_tpu_torch/csrc/point_scan.cu",
    "double_n": "zksnark_tpu_torch/csrc/point_ops.cu",
    "horner": "zksnark_tpu_torch/csrc/point_scan.cu",
    "mont_scan": "zksnark_tpu_torch/csrc/mont_scan.cu",
    "normalize": "zksnark_tpu_torch/csrc/mont_scan.cu",
    "comb": "zksnark_tpu_torch/csrc/point_comb.cu",
    "add_gather": "zksnark_tpu_torch/csrc/point_tail.cu",
    "abel": "zksnark_tpu_torch/csrc/point_tail.cu",
    "block_scan": "zksnark_tpu_torch/csrc/point_tail.cu",
}
# the elementwise double, madd, add, double_n and Fq product have no
# launch on the main path's proves: the MSM's doubling chains run in abel
# (and horner on the mesh), its mixed adds in the bucket scan, its tail's
# adds in add_gather and abel, setup's mixed adds in the comb, its window
# tables' doublings in double_n, batch_normalize's products in mont_scan
# and normalize; the batched NTT runs on the mesh path only, where every
# transform is batched; the wide rows' kernel only where a circuit has
# rows wider than its ELL (none of the circuits here); the chunked add
# scan neither: the MSM's carries and tree sum run as block scans; horner
# on the mesh path only: a single-device prove's MSMs run over the window
# tables
ELEMENTWISE = ("double_g1", "double_g2", "madd_g1", "madd_g2", "add_g1",
               "add_g2", "double_n_g1", "double_n_g2", "montmul_fq",
               "wide_rows_fr", "add_scan_g1", "add_scan_g2")
OFF_PATH = ELEMENTWISE + ("ntt_fr_batched", "horner_g1", "horner_g2")
MESH_OFF_PATH = ELEMENTWISE + ("ntt_fr",)
MESH_ONLY = ("ntt_fr_batched",)
# result name -> TPU_KERNELS / SOURCES key, where not the name's stem
OP_OF = {"ntt_fr_batched": "ntt"}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


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


def time_once(fn):
    """(milliseconds of one call, CUDA events around it, no warm-up; its
    output): for the slow plain versions at the path's shapes."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


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
    from zksnark_tpu_torch.ops import msm

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

    # K1 fused with an add (the prover's s u + r v): random and edge
    # operands against the plain version and host ints, an (x, y) pair of
    # edge values a launch and one random pair
    p = FR_CTX.p
    edge = [0, 1, p - 1, p - 2, (p - 1) // 2, FR_CTX.r_int]
    ea = [x for x in edge for _ in edge]
    eb = [y for _ in edge for y in edge]
    a = np.concatenate([rand_field(rng, p, (n_rand,)), ea])
    b = np.concatenate([rand_field(rng, p, (n_rand,)), eb])
    ta = torch.from_numpy(FR_CTX.to_limbs_np(a)).to(dev)
    tb = torch.from_numpy(FR_CTX.to_limbs_np(b)).to(dev)
    rinv = pow(1 << 256, -1, p)
    err, sem = 0, True
    for xy in [(p - 1, p - 2), (0, 1), (FR_CTX.r_int, (p - 1) // 2),
               tuple(int(v) for v in rand_field(rng, p, (2,)))]:
        txy = torch.from_numpy(FR_CTX.to_limbs_np(list(xy))).to(dev)
        got = mm.mont_mul_add(ta, tb, txy)
        err = max(err, limb_err(got, mm.mont_mul_add_plain(ta, tb, txy)))
        vals = FR_CTX.from_limbs_np(got[-len(ea):].cpu().numpy())
        sem = sem and all(int(v) == (u * xy[0] + w * xy[1]) * rinv % p
                          for v, u, w in zip(vals, ea, eb))
    results["montmul_add_fr"] = {"max_abs_err": err, "bit_exact": err == 0,
                                 "host_edge_ok": sem, "n_checked": len(a)}
    log(f"[kernels] montmul_add_fr: 4 x {len(a)} products and sums, max "
        f"|kernel - plain| = {err}, edge values vs host ints "
        f"{'ok' if sem else 'FAIL'}")

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

        # block_scan: the random points (a step at infinity 1 time in 16)
        # as (rows, 16) columns, whole and less 3 rows, at a block of one
        # thread, 4 x 2, 64 x 4 and the chooser's shape; edge columns of
        # real points (4 threads x 2 steps): A + A doubles in a thread's
        # walk, C + (-C) cancels, two threads' equal sums (D and D) double
        # in the first round, a column all at infinity, and a column whose
        # two blocks are equal (its block totals are); collect on and off
        cols = jac.JPoint(*(c.reshape((n_rand // 16, 16) + c.shape[1:])
                            for c in P_inf))
        col0 = [A, A, C, hneg(C), None, D, None, D] * 2
        col2 = [B, C, D, A, hadd(A, B), None, C, B] * 2
        host_cols = [[a, None, b] for a, b in zip(col0, col2)]
        edge_cols = scaled(pts([h for row in host_cols for h in row]), 3)
        edge_cols = jac.JPoint(*(c.reshape((16, 3) + c.shape[1:])
                                 for c in edge_cols))
        err, sem = 0, True
        for grid, shapes in (
                (cols, [(1, 1), (4, 2), (64, 4),
                        ck.block_scan_shape(cols.z.shape[0], 16)]),
                (jac.JPoint(*(c[:-3] for c in cols)), [(64, 4)]),
                (edge_cols, [(4, 2)])):
            for t, st in shapes:
                for collect in (True, False):
                    got = ck.block_scan(ops, grid, collect, t, st)
                    want = ck.block_scan_plain(ops, grid, collect, t, st)
                    torch.cuda.synchronize()
                    err = max(err, err_of(got[0], want[0]))
                    if collect:
                        err = max(err, err_of(got[1], want[1]))
        run = []
        acc = [None] * 3
        for i, row in enumerate(host_cols):
            if i % 8 == 0:
                acc = [None] * 3
            acc = [hadd(a, h) for a, h in zip(acc, row)]
            run.append(acc)
        totals, within = ck.block_scan(ops, edge_cols, True, 4, 2)
        sem = affine(jac.JPoint(*(c.reshape((48,) + c.shape[2:])
                                  for c in within))) == [
            h for row in run for h in row]
        sem &= affine(jac.JPoint(*(c.reshape((6,) + c.shape[2:])
                                   for c in totals))) == [
            h for row in (run[7], run[15]) for h in row]
        n_pts = 2 * cols.z.numel() // cols.z[0, 0].numel() + 48
        results[f"block_scan_{g}"] = {
            "max_abs_err": err, "bit_exact": err == 0, "host_edge_ok": sem,
            "n_checked": n_pts}
        log(f"[kernels] block_scan_{g}: {cols.z.shape[0]} and "
            f"{cols.z.shape[0] - 3} rows x 16 columns at 1 x 1, 4 x 2, 64 x 4 "
            f"and the chooser's shape, and 16 x 3 edge columns, collect on "
            f"and off, max |kernel - plain| = {err}, edge columns vs host "
            f"curve {'ok' if sem else 'FAIL'}")

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

        # -- the MSM's tail ------------------------------------------------
        # add_gather: n_rand outputs over the random tables (an index < 0
        # on either side 1 time in 16 each) and the edge rows of
        # tail_edge_case over tables of real points, in one launch; P and
        # Q one table, as in a Hillis-Steele round; and the bucket ends
        # of a random bucket scan (W = 3, 16 buckets; window 0's digits
        # >= 5, so its first five buckets are empty ahead of its first
        # run), as the MSM gathers them
        def idx(rows, n):
            i = rng.integers(0, rows, size=n)
            i[rng.random(n) < 1 / 16] = -1
            return torch.from_numpy(i.astype(np.int32)).to(dev)

        ep, epi, eq, eqi, host_want = tail_edge_case(
            pts, scaled, cat, hadd, hneg, A, B, C, D)
        gp, gq = cat(P_rand, ep), cat(Q_rand, eq)
        gpi = torch.cat([idx(n_rand + 6, n_rand),
                         torch.where(epi < 0, epi, epi + n_rand).to(dev)])
        gqi = torch.cat([idx(n_rand + 5, n_rand),
                         torch.where(eqi < 0, eqi, eqi + n_rand).to(dev)])
        cases = [(gp, gpi, gq, gqi)]
        i = torch.arange(n_rand, dtype=torch.int32, device=dev)
        cases.append((P_rand, i - 1, P_rand, i))
        cases.append((P_rand, torch.flip(i, (0,)), P_rand, i))
        d = torch.from_numpy(np.stack([
            rng.integers(5, 16, nr), rng.integers(0, 16, nr),
            rng.integers(0, 16, nr)])).to(dev)
        d_sorted, order = torch.sort(d, dim=1)
        ends_w, chunk, valid, totals = ck.bucket_scan(
            ops, tab_aff, order, d_sorted, 16, 64, True)
        b = totals.z.shape[0]
        carry = msm._prefix_scan(ops, cat(jac.infinity(ops, (1, 3), dev),
                                          jac.JPoint(*(a[:b - 1]
                                                       for a in totals))))
        fpi, fqi = msm._fill_indices(chunk, valid)
        cases.append((carry, fpi, ends_w, fqi))
        err = 0
        for args in cases:
            got = ck.add_gather(ops, *args)
            want = ck.add_gather_plain(ops, *args)
            torch.cuda.synchronize()
            err = max(err, err_of(got, want))
        got = ck.add_gather(ops, *cases[0])
        rows = [n_rand + k for k in host_want]
        sem = affine(jac.JPoint(*(a[rows] for a in got))) == \
            list(host_want.values())
        # both indices < 0: the canonical infinity, limb for limb
        inf = jac.infinity(ops, (1,), dev)
        sem &= all(torch.equal(a[n_rand + 4:n_rand + 5], b)
                   for a, b in zip(got, inf))
        leading = bool((fqi[:5, 0] < 0).all() and (fpi[:5, 0] < 0).all())
        results[f"add_gather_{g}"] = {
            "max_abs_err": err, "bit_exact": err == 0,
            "host_edge_ok": sem and leading,
            "n_checked": sum(a[1].numel() for a in cases)}
        log(f"[kernels] add_gather_{g}: {n_rand} + {len(rows)} edge "
            f"outputs over two tables, {n_rand} over one table twice, the "
            f"bucket ends of a 3-window scan of {nr} points (window 0's "
            f"first 5 buckets empty: {leading}), max |kernel - plain| = "
            f"{err}, edge rows vs host curve {'ok' if sem else 'FAIL'}")

        # abel: random (C, T, R) and the edge rows of abel_edge_case, k =
        # 0, 1 and 16
        cc, tt, r_of, abel_want = abel_edge_case(
            pts, scaled, cat, hadd, hneg, smul, A, B, C, D)
        rand3 = [jac.JPoint(rnd((n_rand,)), rnd((n_rand,)), rnd((n_rand,)))
                 for _ in range(3)]
        err, sem = 0, True
        for k in (0, 1, 16):
            three = [cat(rand3[0], cc), cat(rand3[1], tt),
                     cat(rand3[2], r_of(k))]
            got = ck.abel(ops, *three, k)
            want = ck.abel_plain(ops, *three, k)
            torch.cuda.synchronize()
            err = max(err, err_of(got, want))
            sem &= affine(jac.JPoint(*(a[n_rand:] for a in got))) == \
                abel_want(k)
        results[f"abel_{g}"] = {"max_abs_err": err, "bit_exact": err == 0,
                                "host_edge_ok": sem,
                                "n_checked": three[0].z.shape[0]}
        log(f"[kernels] abel_{g}: {three[0].z.shape[0]} windows, k = 0, 1, "
            f"16, max |kernel - plain| = {err}, edge rows vs host curve "
            f"{'ok' if sem else 'FAIL'}")

    setup_chain_checks(dev, rng, n_rand, results)

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
    ntt_batch_check(dev, seed, results)


# ---------------------------------------------------------------------------
# setup's chains: the prefix-product scan (K1) and the comb encryption (K2)
# ---------------------------------------------------------------------------

def comb_base(ops):
    """The setup's comb base for the group of `ops` (the generator times
    its ENCRYPT scale), as `device_setup` takes it."""
    from zksnark_tpu_torch.curve import bn254 as hc
    from zksnark_tpu_torch.field import params

    if ops.elem_ndim == 1:
        return hc.g1_scalar_mul(hc.G1_GEN_PT, params.ENCRYPT_G1_SCALE)
    return hc.g2_scalar_mul(hc.G2_GEN, params.ENCRYPT_G2_SCALE)


def scan_levels(n: int) -> list:
    """The `mont_scan` launches of one `_prefix_prod` of n elements, in
    order: (rows, row length, from carries, every prefix written)."""
    from zksnark_tpu_torch.ops.montmul import scan_chunk

    c = scan_chunk(n)
    b = -(-n // c)
    if b == 1:
        return [(1, c, False, True)]
    return [(b, c, False, False)] + scan_levels(b) + [(b, c, True, True)]


@contextlib.contextmanager
def scan_plain():
    """Route `ops.montmul.mont_scan` to its plain version on CUDA tensors
    too, for the duration: `curve.jacobian._prefix_prod` then runs as it
    runs on the CPU, where the tests hold it to the JAX package's."""
    from zksnark_tpu_torch.ops import montmul as mm

    saved = mm.mont_scan
    mm.mont_scan = mm.mont_scan_plain
    try:
        yield
    finally:
        mm.mont_scan = saved


def host_fmul(fq2: bool):
    """The field product on host ints (Fq, or Fq2 as (c0, c1) pairs)."""
    from zksnark_tpu_torch.field.limb import FQ_CTX

    q = FQ_CTX.p
    if not fq2:
        return lambda a, b: a * b % q
    return lambda a, b: ((a[0] * b[0] - a[1] * b[1]) % q,
                         (a[0] * b[1] + a[1] * b[0]) % q)


def setup_chain_checks(dev, rng, n_rand: int, results: dict) -> None:
    """mont_scan and normalize (Fq, Fq2) and comb (G1, G2) against their
    plain versions
    on the same CUDA inputs, bit for bit: random grids and scalars, then
    the edge cases, which must also equal the host arithmetic.  Scan:
    rows of 1, 64, 300 (a thread's share uneven) and 2048 (the path's)
    elements, with and without carries and prefixes, zero elements (1 in
    16 of the random ones), rows of one element, one row of 64, a zero
    and a one carry, and `_prefix_prod` of n_rand + 37 elements against
    itself on the plain scan (`scan_plain`).  Normalize: random
    points (Z = 0 one time in 16) and products, one point alone, and
    batch_normalize of real points with other Z and infinities.  Comb:
    n_rand random scalars and the scalars 0 (the identity: every digit 0), 1, 2, 255,
    256, 2^248, r - 1, 2^256 - 1 (every digit 255) and one with zero
    bytes between nonzero ones."""
    from zksnark_tpu_torch.curve import bn254 as hc
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.field.limb import FQ_CTX, FR_CTX
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import montmul as mm

    q = FQ_CTX.p
    for ops, fname, g in ((FQ_OPS, "fq", "g1"), (FQ2_OPS, "fq2", "g2")):
        fq2 = ops.elem_ndim == 2
        ecount = (2,) if fq2 else ()
        kops = ops.on_kernel()

        def mont(shape, zeros=0.0):
            vals = rand_field(rng, q, shape + ecount)
            if zeros:
                vals[rng.random(shape) < zeros] = 0
            return torch.from_numpy(FQ_CTX.to_mont_np(vals)).to(dev)

        def scan_err(grid, carry, collect):
            got = mm.mont_scan(ops, grid, carry, collect)
            want = mm.mont_scan_plain(ops, grid, carry, collect)
            torch.cuda.synchronize()
            err = limb_err(got[0], want[0])
            return max(err, limb_err(got[1], want[1])) if collect else err

        err = 0
        for c in (1, 64, 300, 2048):
            grid = mont((n_rand // c, c), zeros=1 / 16)
            carry = mont((n_rand // c,))
            for cr in (None, carry):
                for collect in (True, False):
                    err = max(err, scan_err(grid, cr, collect))
        x = mont((n_rand + 37,), zeros=1 / 4096)
        got = jac._prefix_prod(kops, x)
        with scan_plain():
            want = jac._prefix_prod(ops, x)
        torch.cuda.synchronize()
        err = max(err, limb_err(got, want))
        # edge rows, against host ints: rows of one element from carries
        # (random, zero, one), and one row of 64 holding a zero and ones
        host = host_fmul(fq2)
        one_h = (1, 0) if fq2 else 1
        e_grid = mont((3, 1))
        e_carry = torch.cat([mont((1,)), torch.zeros_like(mont((1,))),
                             ops.one((1,), dev)])
        row = mont((1, 64))
        row[0, 5] = 0
        row[0, 9:20] = ops.one((11,), dev)
        sem = True
        for grid, carry in ((e_grid, e_carry), (row, None)):
            err = max(err, scan_err(grid, carry, True))
            got = mm.mont_scan(ops, grid, carry)[1]
            g_h = FQ_CTX.from_mont_np(got.cpu().numpy())
            x_h = FQ_CTX.from_mont_np(grid.cpu().numpy())
            c_h = (FQ_CTX.from_mont_np(carry.cpu().numpy())
                   if carry is not None else None)
            for b in range(grid.shape[0]):
                acc = one_h if c_h is None else (
                    tuple(int(v) for v in c_h[b]) if fq2 else int(c_h[b]))
                for j in range(grid.shape[1]):
                    xv = (tuple(int(v) for v in x_h[b, j]) if fq2
                          else int(x_h[b, j]))
                    acc = host(acc, xv)
                    gv = (tuple(int(v) for v in g_h[b, j]) if fq2
                          else int(g_h[b, j]))
                    sem &= gv == acc
        name = f"mont_scan_{fname}"
        results[name] = {"max_abs_err": err, "bit_exact": err == 0,
                         "host_edge_ok": sem, "n_checked": 17 * n_rand + 104}
        log(f"[kernels] {name}: grids of ~{n_rand} elements in rows of 1, "
            f"64, 300 and 2048, carries and prefixes on and off, "
            f"_prefix_prod of "
            f"{n_rand + 37}, max |kernel - plain| = {err}, edge rows vs "
            f"host {'ok' if sem else 'FAIL'}")

        # -- the normalize pass: random points (Z = 0 one time in 16) and
        # products, n = 1 (no neighbours); then batch_normalize of real
        # points with other Z, infinity first and in the middle, against
        # the host curve
        nr = n_rand + 37
        pts_r = [mont((nr,)), mont((nr,)), mont((nr,), zeros=1 / 16),
                 mont((nr,)), mont((nr,))]
        tinv = mont((1,))[0]
        err = 0
        for sl in (slice(0, nr), slice(0, 1), slice(7, 8)):
            args = [a[sl] for a in pts_r] + [tinv]
            got = mm.normalize(ops, *args)
            want = mm.normalize_plain(ops, *args)
            torch.cuda.synchronize()
            err = max(err, max(limb_err(a, b) for a, b in zip(got, want)))
        gen = hc.G2_GEN if fq2 else hc.G1_GEN_PT
        smul = hc.g2_scalar_mul if fq2 else hc.g1_scalar_mul
        hpts = [None, smul(gen, 5), smul(gen, 7), None, smul(gen, 11)]
        lams = [1, 3, 5, 1, 7]
        zero_h = (0, 0) if fq2 else 0

        def scale(v, k):                 # v * k for v in Fq or Fq2
            return tuple(c * k % q for c in v) if fq2 else v * k % q

        xs = [zero_h if h is None else scale(h[0], lam * lam)
              for h, lam in zip(hpts, lams)]
        ys = [zero_h if h is None else scale(h[1], lam ** 3)
              for h, lam in zip(hpts, lams)]
        zs = [zero_h if h is None else ((lam, 0) if fq2 else lam)
              for h, lam in zip(hpts, lams)]
        jp = jac.JPoint(*(torch.from_numpy(ops.to_mont_np(v)).to(dev)
                          for v in (xs, ys, zs)))
        norm = jac.batch_normalize(ops, jp)
        aff = [None if a is None else tuple(map(tuple, a)) if fq2 else a
               for a in jac.to_affine_np(ops, norm)]
        zset = {tuple(int(c) for c in np.asarray(v).reshape(-1))
                for v in FQ_CTX.from_mont_np(norm.z.cpu().numpy())}
        one_z = (1, 0) if fq2 else (1,)
        sem = aff == hpts and zset <= {one_z, (0,) * len(one_z)}
        name = f"normalize_{fname}"
        results[name] = {"max_abs_err": err, "bit_exact": err == 0,
                         "host_edge_ok": sem, "n_checked": nr + 2 + 5}
        log(f"[kernels] {name}: {nr} random points and products, n = 1, "
            f"max |kernel - plain| = {err}; batch_normalize of 5 real "
            f"points with other Z and infinities vs host curve "
            f"{'ok' if sem else 'FAIL'}")

        # -- the comb -------------------------------------------------------
        r = FR_CTX.p
        base = comb_base(ops)
        table = prover._comb_table(ops, base, dev)
        edge = [0, 1, 2, 255, 256, 1 << 248, r - 1, (1 << 256) - 1,
                sum(0x5A << (24 * i) for i in range(11))]
        ints = np.concatenate([rand_field(rng, r, (n_rand,)), edge])
        scalars = torch.from_numpy(np.frombuffer(b"".join(
            int(v).to_bytes(32, "little") for v in ints),
            dtype="<i4").reshape(-1, 8).copy()).to(dev)
        want = ck.comb_plain(ops, table, scalars)
        got = ck.comb(ops, table, scalars)
        torch.cuda.synchronize()
        err = max(limb_err(a, b) for a, b in zip(got, want))
        aff = jac.to_affine_np(ops, jac.JPoint(*(a[n_rand:] for a in got)))
        smul = hc.g1_scalar_mul if not fq2 else hc.g2_scalar_mul
        sem = True
        for a, k in zip(aff, edge):
            if fq2 and a is not None:
                a = tuple(map(tuple, a))
            sem &= a == (smul(base, k % r) if k % r else None)
        name = f"comb_{g}"
        results[name] = {"max_abs_err": err, "bit_exact": err == 0,
                         "host_edge_ok": sem, "n_checked": len(ints)}
        log(f"[kernels] {name}: {len(ints)} scalars, max |kernel - plain| "
            f"= {err}, edge scalars vs host curve {'ok' if sem else 'FAIL'}")


# the path's comb: 2^20 scalars (the square chain's xi, xi_t, sum_delta
# and the G2 xi); its scans: every level of a 2^20 _prefix_prod
COMB_M = 1 << 20
SCAN_N = 1 << 20


def setup_chain_timing(dev, seed: int, results: dict) -> None:
    """Setup's mont_scan, normalize and comb at the main path's shapes,
    each entry beside its plain version on the same random CUDA inputs,
    timed and compared bit for bit.  mont_scan: every level of one
    `_prefix_prod` of 2^20 elements (the row's ms, plain_ms and bound_ms
    sum them), and the whole chain (kernel launches and the glue between
    them) against itself on the plain scan.  normalize: 2^20 points.
    comb: 2^20 scalars."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import montmul as mm

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(shape):
        t = torch.randint(-(1 << 31), 1 << 31, tuple(shape) + (8,),
                          dtype=torch.int64, device=dev, generator=gen)
        t[..., 7] &= 0x0FFFFFFF            # below both moduli
        return t.to(torch.int32)

    for ops, fname, g in ((FQ_OPS, "fq", "g1"), (FQ2_OPS, "fq2", "g2")):
        fq2 = ops.elem_ndim == 2
        ecount = (2,) if fq2 else ()
        elem_b = 32 * (2 if fq2 else 1)
        mul_ops = MULADDS_PER_MONT_MUL * (3 if fq2 else 1) + (
            5 * OPS_PER_ADD if fq2 else 0)
        per_shape = []
        for b, c, from_carry, collect in scan_levels(SCAN_N):
            grid = rnd((b, c) + ecount)
            carry = rnd((b,) + ecount) if from_carry else None
            ms, got = time_cuda(
                lambda: mm.mont_scan(ops, grid, carry, collect), 20)
            plain_ms, want = time_cuda(
                lambda: mm.mont_scan_plain(ops, grid, carry, collect), 2)
            err = limb_err(got[0], want[0])
            if collect:
                err = max(err, limb_err(got[1], want[1]))
            byt = elem_b * (b * c + b * (2 if from_carry else 1)
                            + (b * c if collect else 0))
            bnd = bound(byt, b * c * mul_ops)
            per_shape.append({"shape": [b, c, int(from_carry), int(collect)],
                              "ms": ms, "plain_ms": plain_ms, "err": err,
                              **bnd})
            log(f"[timing] mont_scan_{fname} {per_shape[-1]['shape']}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}); max |kernel "
                f"- plain| = {err}")
        x = rnd((SCAN_N,) + ecount)
        kops = ops.on_kernel()
        chain_ms, got = time_cuda(lambda: jac._prefix_prod(kops, x), 10)
        with scan_plain():
            want = jac._prefix_prod(ops, x)
        err = limb_err(got, want)
        name = f"mont_scan_{fname}"
        tb = sum(p["bound_ms"] for p in per_shape)
        results[name].update(
            shape=[p["shape"] for p in per_shape],
            ms=sum(p["ms"] for p in per_shape), chain_ms=chain_ms,
            plain_ms=sum(p["plain_ms"] for p in per_shape),
            path_shape_err=max([err] + [p["err"] for p in per_shape]),
            checked_shapes=[p["shape"] for p in per_shape] + [[SCAN_N]],
            bound_ms=tb, bound_by=max(per_shape,
                                      key=lambda p: p["bound_ms"])["bound_by"],
            per_shape=per_shape)
        log(f"[timing] {name}, one _prefix_prod of {SCAN_N}: kernel "
            f"{results[name]['ms']:.4f} ms over {len(per_shape)} launches "
            f"(the chain with its glue {chain_ms:.4f} ms), plain "
            f"{results[name]['plain_ms']:.3f} ms, bound {tb:.5f} ms; max "
            f"|chain - plain chain| = {err}")

        # -- the normalize pass over 2^20 points -----------------------------
        args = [rnd((SCAN_N,) + ecount) for _ in range(5)] + [rnd(ecount)]
        ms, got = time_cuda(lambda: mm.normalize(ops, *args), 20)
        plain_ms, want = time_cuda(lambda: mm.normalize_plain(ops, *args), 2)
        err = max(limb_err(a, b) for a, b in zip(got, want))
        del got, want
        bnd = bound(8 * elem_b * SCAN_N, 6 * mul_ops * SCAN_N)
        name = f"normalize_{fname}"
        results[name].update(
            shape=[SCAN_N], ms=ms, plain_ms=plain_ms,
            path_shape_err=err, checked_shapes=[SCAN_N], **bnd)
        log(f"[timing] {name} n={SCAN_N}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}); max |kernel - plain| = {err}")

        # -- the comb at 2^20 scalars -----------------------------------------
        table = prover._comb_table(ops, comb_base(ops), dev)
        scalars = rnd((COMB_M,))               # below 2^252 < r
        ms, got = time_cuda(lambda: ck.comb(ops, table, scalars), 5)
        plain_ms, want = time_once(
            lambda: ck.comb_plain(ops, table, scalars))
        err = max(limb_err(a, b) for a, b in zip(got, want))
        del got, want
        cnt = CountingOps(ops)             # one madd: random P + T[0, 1]
        ck.madd_plain(cnt, jac.JPoint(*(rnd((1,) + ecount)
                                        for _ in range(3))),
                      jac.JPoint(*(a[0, 1:2] for a in table)))
        add_ops = cnt.muls * MULADDS_PER_MONT_MUL + cnt.adds * OPS_PER_ADD
        byt = COMB_M * (32 + 3 * elem_b) + 32 * 256 * 3 * elem_b
        bnd = bound(byt, COMB_M * 32 * add_ops)
        name = f"comb_{g}"
        results[name].update(
            shape=[COMB_M], ms=ms,
            plain_ms=plain_ms, path_shape_err=err, checked_shapes=[COMB_M],
            fq_muls=cnt.muls, fq_adds=cnt.adds, **bnd)
        log(f"[timing] {name} m={COMB_M}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}; 32 madds of {cnt.muls} Fq muls, "
            f"{cnt.adds} Fq adds); max |kernel - plain| = {err}")


def rand_limbs(gen, shape) -> torch.Tensor:
    """Random Fr limbs below p (the top limb's high bits cleared)."""
    t = torch.randint(-(1 << 31), 1 << 31, tuple(shape) + (8,),
                      dtype=torch.int64, device=gen.device, generator=gen)
    t[..., 7] &= 0x0FFFFFFF
    return t.to(torch.int32)


def ntt_batch_check(dev, seed: int, results: dict) -> None:
    """The batched NTT pass on random inputs: batches of 3 transforms of
    every log_n from 1 to 12 in the default and an uneven split, and the
    mesh path's four-step batches (NTT_BATCH_SHAPES), forward and
    inverse.  Each must equal its plain version and the same transforms
    launched one at a time (which the checks above hold to the plain
    version and the host DFT) bit for bit."""
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.ops import ntt

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err = one_err = checked = 0
    for b, log_n in [(3, k) for k in range(1, 13)] + NTT_BATCH_SHAPES:
        d = ntt.get_domain(log_n, dev)
        x = rand_limbs(gen, (b, 1 << log_n))
        splits = [d.widths]
        if b == 3 and log_n > 1:
            splits.append((1,) + ntt.pass_widths(log_n - 1))
        for tw in (d.t.tw_table, d.t.tw_table_inv):
            for widths in splits:
                got = ntt.butterflies(FR_CTX, log_n, tw, x, widths)
                want = ntt.butterflies_plain(FR_CTX, log_n, tw, x, widths)
                one = torch.stack([ntt.butterflies(FR_CTX, log_n, tw, x[i],
                                                   widths)
                                   for i in range(b)])
                torch.cuda.synchronize()
                err = max(err, limb_err(got, want))
                one_err = max(one_err, limb_err(got, one))
                checked += b << log_n
    results["ntt_fr_batched"] = {"max_abs_err": err, "bit_exact": err == 0,
                                 "host_edge_ok": one_err == 0,
                                 "n_checked": checked}
    log(f"[kernels] ntt_fr_batched: 3 transforms of log_n 1..12 (default "
        f"and uneven passes) and the four-step batches "
        f"{NTT_BATCH_SHAPES}, forward and inverse, max |kernel - plain| = "
        f"{err}; vs one launch per transform "
        f"{'ok' if one_err == 0 else 'FAIL'}")


def bucket_err(got, want) -> int:
    """Largest difference between two bucket scans' outputs (slots,
    bucket_chunk, valid, totals)."""
    (gs, gc, gv, gt), (ws, wc, wv, wt) = got, want
    errs = [limb_err(a, b) for a, b in zip(list(gs) + list(gt),
                                             list(ws) + list(wt))]
    errs.append(int((gc - wc).abs().max().item()))
    errs.append(int((gv != wv).sum().item()))
    return max(errs)


def tail_edge_case(pts, scaled, cat, hadd, hneg, A, B, C, D):
    """add_gather's edge rows: tables P (A, B, C, infinity, A with another
    Z, D with another Z) and Q (A, -B, D, infinity, C with another Z) of
    real points and nine index pairs: A + A met only through the gather
    (the doubling branch re-reads P's row), B + (-B), an index < 0 on
    either side and on both (row 4: the canonical infinity), an infinity
    row, C + C and D + D with other Z, A + D.  Returns (P, pi, Q, qi,
    {row: host sum}), the indices on the CPU."""
    p = cat(pts([A, B, C, None]), scaled(pts([A]), 7), scaled(pts([D]), 3))
    q = cat(pts([A, hneg(B), D, None]), scaled(pts([C]), 5))
    pi = torch.tensor([4, 1, -1, 2, -1, 3, 2, 5, 0], dtype=torch.int32)
    qi = torch.tensor([0, 1, 2, -1, -1, 4, 4, 2, 2], dtype=torch.int32)
    want = [hadd(A, A), None, D, C, None, C, hadd(C, C), hadd(D, D),
            hadd(A, D)]
    return p, pi, q, qi, dict(enumerate(want))


def abel_edge_case(pts, scaled, cat, hadd, hneg, smul, A, B, C, D):
    """abel's edge rows (C, T, R): A + A with two Z (the first add
    doubles), B + (-B) (E_top at infinity), infinity + D with R at
    infinity, and A + B with R = 2^k (A + B) (the last add cancels) and
    with R = -2^k (A + B) (the last add doubles).  Returns (C, T, R of k,
    host results of k)."""
    c = cat(scaled(pts([A]), 2), pts([B, None, A]), scaled(pts([A]), 7))
    t = cat(scaled(pts([A]), 3), pts([hneg(B), D]), scaled(pts([B]), 5),
            pts([B]))

    def top(k):
        return smul(hadd(A, B), 1 << k)

    def r_of(k):
        return cat(pts([B]), scaled(pts([C]), 4), pts([None]),
                   scaled(pts([top(k)]), 6), pts([hneg(top(k))]))

    def want(k):
        return [hadd(smul(A, 2 << k), hneg(B)), hneg(C), smul(D, 1 << k),
                None, hadd(top(k), top(k))]

    return c, t, r_of, want


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
        ops_n = MULADDS_PER_MONT_MUL * n
        results[name].update(shape=[n], ms=ms, plain_ms=plain_ms,
                             path_shape_err=err, checked_shapes=checked,
                             **bound(byt, ops_n))
        log(f"[timing] {name} n={n}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {results[name]['bound_ms']:.4f} ms "
            f"({results[name]['bound_by']}); max |kernel - plain| at "
            f"n={checked} = {err}")

    # the prover's s u + r v: two products with broadcast operands and a
    # sum over the 2^20 coefficients
    n = shapes["montmul_add_fr"]
    a, b, xy = rnd(n, FR_CTX), rnd(n, FR_CTX), rnd(2, FR_CTX)
    ms, got = time_cuda(lambda: mm.mont_mul_add(a, b, xy), 50)
    plain_ms, want = time_cuda(lambda: mm.mont_mul_add_plain(a, b, xy), 3)
    err = limb_err(got, want)
    results["montmul_add_fr"].update(
        shape=[n], ms=ms, plain_ms=plain_ms, path_shape_err=err,
        checked_shapes=[n],
        **bound(3 * 32 * n, (2 * MULADDS_PER_MONT_MUL + OPS_PER_ADD) * n))
    log(f"[timing] montmul_add_fr n={n}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {results['montmul_add_fr']['bound_ms']:.4f}"
        f" ms ({results['montmul_add_fr']['bound_by']}); max |kernel - "
        f"plain| = {err}")

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
            ops_n = (cnt.muls * MULADDS_PER_MONT_MUL
                     + cnt.adds * OPS_PER_ADD) * n
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
                    if m <= 4096:
                        per_shape[-1]["device_ms"] = device_ms(
                            lambda: kern(ops, *a2))
                        log(f"[timing] {name} n={m}: device time "
                            f"{per_shape[-1]['device_ms']:.4f} ms "
                            f"(profiler)")
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
        tail_timing(ops, g, lambda n: jac.JPoint(
            rnd(n, FQ_CTX, elem), rnd(n, FQ_CTX, elem),
            rnd(n, FQ_CTX, elem)), gen, results)
        bucket_timing(ops, g, lambda n: rnd(n, FQ_CTX, elem), gen, results)
        if g == "g1":
            bucket_c_msm(lambda n: rnd(n, FQ_CTX, elem), gen, results)
    setup_chain_timing(dev, seed, results)
    ntt_timing(rnd(1 << NTT_LOG_N, FR_CTX), results)
    ntt_batch_timing(gen, results)


# shapes: montmul_fr at the prove's elementwise products (n^-1, coset,
# vanishing, from_mont: 2^20; the NTT stages' 2^19 now run inside the NTT
# kernel); montmul_fq and madd at their former shapes on the path, a
# step of batch_normalize's prefix products (2^20 / 64) and of setup's
# comb encryption (2^20 scalars), now run by mont_scan, normalize and
# comb (the bucket scan runs the MSM's mixed adds); add at the former
# MSM bucket ends (16 windows x 2^16 buckets; add_gather runs them); double
# at the former Abel step (one point per window; abel runs it)
PATH_SHAPES = {"montmul_fr": 1 << 20, "montmul_add_fr": 1 << 20,
               "montmul_fq": 1 << 14,
               "madd": 1 << 20, "add": 1 << 20, "double": 16}
# the elementwise add's former shapes in one 2^20 MSM (c = 16), run by
# add_gather and abel since, and by the block scans' fix-ups: bucket
# ends, the two chunk-carry fix-ups, the small Hillis-Steele rounds,
# E_top and the Abel subtraction (2^20, 2^18, 4096, 64 twice, 16 twice)
ADD_SHAPES = [1 << 20, 1 << 18, 4096, 64, 16]
# the chains at the shapes of one 2^20 MSM (c = 16: W = 16 windows, 2^14
# chunks of 64 sorted points per window): (chunks, steps, lanes per chunk,
# collect) of the two chunk-carry scans and the three tree-sum levels
# that add_scan ran, off the prove path since the block scans
SCAN_SHAPES = [(256, 64, 16, True), (4, 64, 16, True), (1024, 64, 16, False),
               (16, 64, 16, False), (1, 16, 16, False)]
# double_n at setup's window tables (`ops.msm.window_table`, c = 16): one
# launch a block of the three G1 sets side by side (3 (2^20 + 3) points)
# and of the G2 set (2^20 + 2), 16 doublings each
DOUBLE_N_SHAPE = {"g1": (3 * ((1 << 20) + 3), 16), "g2": ((1 << 20) + 2, 16)}
# Horner (the mesh path's): W windows, c doublings each, MSMs side by side
# (a prove's four G1 MSMs share one launch; its G2 MSM has its own)
HORNER_SHAPE = {"g1": (16, 16, 4), "g2": (16, 16, 1)}


# the bucket scans of one prove on the table path (`ops.msm.msm_tables`,
# c = 16): one window a scalar set over a table of W = 16 blocks of m rows,
# the digits laid out w-major as the table's rows; xi_g1's table takes two
# sets (A and C - h - c_delta), xi_t_g1's and sum_delta_g1's one each (G1,
# m = 2^20 + 3), xi_g2's one (G2, m = 2^20 + 2): (m, [(sets, launches a
# prove), ...])
BUCKET_TABLES = {"g1": ((1 << 20) + 3, [(2, 1), (1, 2)]),
                 "g2": ((1 << 20) + 2, [(1, 1)])}
# the windowed formulation's bucket scan (the mesh path, `msm`,
# `msm_windowed`) at one 2^20 MSM: W windows of c-bit digits
BUCKET_SHAPE = {"windows": 16, "c": 16, "n": 1 << 20}
NTT_LOG_N = 20                   # the prove's transforms; checked 1 .. 20
# the mesh path's four-step batches, (transforms, log n) of a rank's
# half-transform: d = 1 at n = 2^20 (n1 = n2 = 2^10), then d = 2 and d = 4
# at n = 2^18 (n1 = n2 = 2^9)
NTT_BATCH_SHAPES = [(1 << 10, 10), (1 << 8, 9), (1 << 7, 9)]


def table_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """The (J, W m) digit rows of J sets of m scalars, (J, m, 8), laid out
    w-major as a window table's rows (`ops.msm.msm_tables`)."""
    from zksnark_tpu_torch.ops import msm

    return torch.stack([msm._digit_columns(s, c).reshape(-1)
                        for s in scalars])


def bucket_bound(ops, g, tab, windows: int, nb: int, points: int):
    """What a bucket scan of `windows` windows over the table `tab` needs:
    a mixed add per real point and window, the table and the digits and
    order read, the slots, chunk indices, flags and chunk totals
    written."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck

    cnt = CountingOps(ops)
    ck.madd_plain(cnt, *(jac.JPoint(*(a[i:i + 1] for a in tab))
                         for i in (0, 1)))
    rows = tab.z.shape[0]
    elem_b = 32 * (1 if g == "g1" else 2)
    b = -(-rows // 64)
    byt = (3 * elem_b * rows + 2 * 8 * windows * rows
           + windows * nb * (3 * elem_b + 9) + 3 * elem_b * b * windows)
    return bound(byt, windows * points * (cnt.muls * MULADDS_PER_MONT_MUL
                                          + cnt.adds * OPS_PER_ADD))


def bucket_timing(ops, g, rnd_elem, gen, results) -> None:
    """The bucket scans of one 2^20 prove on the table path (`BUCKET_TABLES`:
    one or two windows over a table of 16 m rows with a point at
    infinity 1 time in 16, the digits of random scalars laid out w-major
    and sorted as `msm_tables` sorts them), and the windowed
    formulation's at one 2^20 MSM (`BUCKET_SHAPE`): the kernel and its
    plain version, on the same inputs, timed and compared.  The entry's
    ms / plain_ms / bound_ms / launches sum the prove's launches."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import msm

    c = BUCKET_SHAPE["c"]
    nb = 1 << c
    dev = gen.device

    def table(rows):
        zm = torch.randint(0, 16, (rows,), device=dev, generator=gen) == 0
        return jac.JPoint(rnd_elem(rows), rnd_elem(rows), ops.select(
            zm, ops.zero((rows,), dev), ops.one((rows,), dev)).contiguous())

    def row(tab, d_sorted, order, path):
        windows, rows = order.shape
        args = (ops, tab, order, d_sorted, nb, 64, True)
        ms, got = time_cuda(lambda: ck.bucket_scan(*args), 5)
        plain_ms, want = time_cuda(lambda: ck.bucket_scan_plain(*args), 1)
        out = {"shape": [windows, c, rows], "path": path, "ms": ms,
               "plain_ms": plain_ms, "err": bucket_err(got, want),
               **bucket_bound(ops, g, tab, windows, nb, rows)}
        log(f"[timing] bucket_scan_{g} {path} W={windows} c={c} "
            f"rows={rows}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}); max "
            f"|kernel - plain| = {out['err']}")
        return out

    m, sets = BUCKET_TABLES[g]
    tab = table(msm.table_windows(c) * m)
    per_shape = []
    for j, launches in sets:
        scalars = rand_limbs(gen, (j, m))
        d_sorted, order = torch.sort(table_digits(scalars, c), dim=1)
        per_shape.append(dict(row(tab, d_sorted, order, "tables 2^20"),
                              launches=launches))
        del d_sorted, order
    del tab
    W, n = BUCKET_SHAPE["windows"], BUCKET_SHAPE["n"]
    d_sorted, order = torch.sort(torch.randint(
        0, nb, (W, n), device=dev, generator=gen), dim=1)
    per_shape.append(dict(row(table(n), d_sorted, order, "windowed 2^20"),
                          launches=0))
    path = [p for p in per_shape if p["launches"]]
    name = f"bucket_scan_{g}"
    results[name].update(
        shape=[p["shape"] for p in path],
        **{k: sum(p["launches"] * p[k] for p in path)
           for k in ("ms", "plain_ms", "bound_ms")},
        bound_by=max(path, key=lambda p: p["bound_ms"])["bound_by"],
        launches=sum(p["launches"] for p in path),
        path_shape_err=max(p["err"] for p in per_shape),
        checked_shapes=[[p["path"]] + p["shape"] for p in per_shape],
        per_shape=per_shape)
    log(f"[timing] {name}, summed over one 2^20 prove's launches "
        f"({results[name]['launches']}): kernel {results[name]['ms']:.4f} "
        f"ms, bound {results[name]['bound_ms']:.4f} ms")


# the keccak path's C MSM (`examples/keccak_proof.py`, n = 2^18) on its
# window table: its scalars are the witness tail, num_wires - input - 1 =
# 231,761 values of 0 or 1 padded with zeros (and the points with
# infinity) to m = 2^18 + 3 rows a block, so the first block's digits are
# 0 / 1 and blocks 1-15 hold one digit-0 run
C_MSM_SHAPE = {"blocks": 16, "c": 16, "m": (1 << 18) + 3, "points": 231761}


def bucket_c_msm(rnd_elem, gen, results) -> None:
    """The G1 bucket scan at the C MSM's digits on its window table (one
    run of digit 0 over 15 of the 16 blocks, two runs in the first), the
    table padded with infinity as the prove pads it: kernel and plain
    version on the same inputs, compared and timed; then the same table
    with random digits, to tell the digits' share of the time from the
    size's."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ_OPS as ops
    from zksnark_tpu_torch.ops import curve_kernels as ck

    W, c, m, pts = (C_MSM_SHAPE[k] for k in ("blocks", "c", "m", "points"))
    rows = W * m
    dev = gen.device
    pad = torch.arange(rows, device=dev) % m >= pts
    tab = jac.JPoint(rnd_elem(rows), rnd_elem(rows), ops.select(
        pad, ops.zero((rows,), dev), ops.one((rows,), dev)).contiguous())
    scalars = torch.zeros((1, m, 8), dtype=torch.int32, device=dev)
    scalars[0, :pts, 0] = torch.randint(0, 2, (pts,), dtype=torch.int32,
                                        device=dev, generator=gen)
    digits = table_digits(scalars, c)
    if int(digits[:, m:].max()) != 0 or int(digits.max()) != 1:
        raise SystemExit("C MSM digit rows are not as described")
    d_sorted, order = torch.sort(digits, dim=1)
    args = (ops, tab, order, d_sorted, 1 << c, 64, True)
    ms, got = time_cuda(lambda: ck.bucket_scan(*args), 5)
    plain_ms, want = time_cuda(lambda: ck.bucket_scan_plain(*args), 1)
    err = bucket_err(got, want)
    d_rand, o_rand = torch.sort(torch.randint(
        0, 1 << c, (1, rows), device=dev, generator=gen), dim=1)
    args = (ops, tab, o_rand, d_rand, 1 << c, 64, True)
    rand_ms, got = time_cuda(lambda: ck.bucket_scan(*args), 5)
    err = max(err, bucket_err(got, ck.bucket_scan_plain(*args)))
    del got, want
    bnd = bucket_bound(ops, "g1", tab, 1, 1 << c, W * pts)
    r = results["bucket_scan_g1"]
    r["c_msm"] = {"shape": [1, c, rows], "digits": "block 0 in {0, 1}, "
                  f"blocks 1-{W - 1} all 0", "ms": ms, "plain_ms": plain_ms,
                  "random_digits_ms": rand_ms, "err": err, **bnd}
    r["path_shape_err"] = max(r["path_shape_err"], err)
    r["checked_shapes"] = r["checked_shapes"] + [["tables 2^18", 1, c, rows,
                                                  "0/1"]]
    log(f"[timing] bucket_scan_g1 at the C MSM's table W=1 c={c} "
        f"rows={rows} ({pts} points a block, block 0 in {{0, 1}}, blocks "
        f"1-{W - 1} all 0): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); the same table "
        f"with random digits: kernel {rand_ms:.4f} ms; max |kernel - "
        f"plain| = {err}")


def ntt_timing(x, results) -> None:
    """One 2^20 transform (the prove's size): the kernel's passes and its
    plain version, on the same input, timed and compared."""
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.ops import ntt

    log_n = NTT_LOG_N
    d = ntt.get_domain(log_n, x.device)
    tw = d.t.tw_table
    ms, got = time_cuda(lambda: ntt.ntt(d, x), 20)
    plain_ms, want = time_cuda(lambda: ntt.butterflies_plain(
        FR_CTX, log_n, tw, x, d.widths), 1)
    err = limb_err(got, want)
    n = 1 << log_n
    bnd = bound(32 * (2 * n + n // 2),
                log_n * (n // 2) * (MULADDS_PER_MONT_MUL + 2 * OPS_PER_ADD))
    results["ntt_fr"].update(shape=[n], ms=ms,
                             plain_ms=plain_ms, path_shape_err=err,
                             checked_shapes=[n], widths=list(d.widths),
                             **bnd)
    log(f"[timing] ntt_fr n=2^{log_n} passes {d.widths}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}); max |kernel - plain| = {err}")


def ntt_batch_timing(gen, results) -> None:
    """The batched NTT at the mesh path's four-step batches: the kernel
    (one launch per pass for the whole batch) and its plain version, on
    the same input, timed and compared."""
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.ops import ntt

    per_shape = []
    for b, log_n in NTT_BATCH_SHAPES:
        d = ntt.get_domain(log_n, gen.device)
        x = rand_limbs(gen, (b, 1 << log_n))
        ms, got = time_cuda(lambda: ntt.ntt(d, x), 20)
        plain_ms, want = time_cuda(lambda: ntt.butterflies_plain(
            FR_CTX, log_n, d.t.tw_table, x, d.widths), 1)
        err = limb_err(got, want)
        n = 1 << log_n
        bnd = bound(32 * (2 * b * n + n // 2), b * log_n * (n // 2)
                    * (MULADDS_PER_MONT_MUL + 2 * OPS_PER_ADD))
        per_shape.append({"shape": [b, n], "ms": ms,
                          "plain_ms": plain_ms, "err": err,
                          "widths": list(d.widths), **bnd})
        log(f"[timing] ntt_fr_batched {b} x 2^{log_n} passes {d.widths}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); max |kernel - "
            f"plain| = {err}")
    first = per_shape[0]
    results["ntt_fr_batched"].update(
        shape=first["shape"], ms=first["ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], per_shape=per_shape,
        checked_shapes=[p["shape"] for p in per_shape],
        path_shape_err=max(p["err"] for p in per_shape))


def chain_timing(ops, g, rnd_pts, results) -> None:
    """add_scan, double_n and horner at the path's shapes: each entry and
    its plain version, on the same inputs, timed and compared.  A row's
    ms / plain_ms / bound_ms are the sums over its shapes: one MSM's
    worth (for horner, one launch's on the mesh path: a prove's four G1
    MSMs, or its G2 MSM; for double_n, one launch of setup's window
    tables: a block of a group's sets)."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck

    elem_b = 32 * (1 if g == "g1" else 2)
    cnt_add, cnt_dbl = CountingOps(ops), CountingOps(ops)
    one = rnd_pts(1)
    ck.add_plain(cnt_add, one, rnd_pts(1))
    ck.double_plain(cnt_dbl, one)
    add_ops = cnt_add.muls * MULADDS_PER_MONT_MUL + cnt_add.adds * OPS_PER_ADD
    dbl_ops = cnt_dbl.muls * MULADDS_PER_MONT_MUL + cnt_dbl.adds * OPS_PER_ADD

    def err_of(a, b):
        return max(limb_err(u, v) for u, v in zip(a, b))

    def scan_case(b, c, r, collect):
        grid = jac.JPoint(*(a.reshape((b, c, r) + a.shape[1:])
                            for a in rnd_pts(b * c * r)))
        ms, got = time_cuda(lambda: ck.add_scan(ops, grid, collect), 10)
        plain_ms, want = time_cuda(
            lambda: ck.add_scan_plain(ops, grid, collect), 1)
        err = err_of(got[0], want[0])
        if collect:
            err = max(err, err_of(got[1], want[1]))
        lanes = b * r
        byt = elem_b * 3 * (lanes * c + lanes + (lanes * c if collect else 0))
        return ([b, c, r, int(collect)], ms, plain_ms, err,
                bound(byt, lanes * c * add_ops))

    def double_n_case(n, k):
        p = rnd_pts(n)
        ms, got = time_cuda(lambda: ck.double_n(ops, p, k), 20)
        plain_ms, want = time_cuda(lambda: ck.double_n_plain(ops, p, k), 1)
        return ([n, k], ms, plain_ms, err_of(got, want),
                bound(elem_b * 3 * 2 * n, n * k * dbl_ops))

    def horner_case(w, c, m):
        sums = jac.JPoint(*(a.reshape((w, m) + a.shape[1:])
                            for a in rnd_pts(w * m)))
        ms, got = time_cuda(lambda: ck.horner(ops, sums, c), 20)
        plain_ms, want = time_cuda(lambda: ck.horner_plain(ops, sums, c), 1)
        return ([w, c, m], ms, plain_ms, err_of(got, want),
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
             "double_n": [double_n_case(*DOUBLE_N_SHAPE[g])],
             "horner": [horner_case(*HORNER_SHAPE[g])]}
    for op, rows in cases.items():
        name = f"{op}_{g}"
        per_shape = []
        for shape, ms, plain_ms, err, bnd in rows:
            per_shape.append({"shape": shape, "ms": ms,
                              "plain_ms": plain_ms, "err": err, **bnd})
            log(f"[timing] {name} {shape}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.5f} ms "
                f"({bnd['bound_by']}); max |kernel - plain| = {err}")
        tb = sum(p["bound_ms"] for p in per_shape)
        by = max(per_shape, key=lambda p: p["bound_ms"])["bound_by"]
        results[name].update(
            shape=[p["shape"] for p in per_shape],
            ms=sum(p["ms"] for p in per_shape),
            plain_ms=sum(p["plain_ms"] for p in per_shape),
            path_shape_err=max(p["err"] for p in per_shape),
            checked_shapes=[p["shape"] for p in per_shape],
            bound_ms=tb, bound_by=by, per_shape=per_shape,
            thread_add_us=add_us, thread_double_us=dbl_us)
        log(f"[timing] {name}, summed over its shapes: kernel "
            f"{results[name]['ms']:.4f} ms, bound {tb:.5f} ms")


# the MSM's tail (c = 16) as the table path runs it, one tail a group and
# prove over the chunk totals of bucket scans with a column an MSM (G1:
# its four MSMs side by side over tables of 16 (n + 3) rows; G2: its MSM
# over 16 (n + 2)), at n = 2^20 and 2^18; and as the windowed formulation
# runs it (the mesh path, `msm`, `msm_windowed`) at one 2^20 MSM, 16
# windows over 2^20 points: (label, columns, rows of the bucket scan)
TAIL_SHAPES = {
    "g1": [("2^20", 4, 16 * ((1 << 20) + 3)), ("2^18", 4, 16 * ((1 << 18) + 3)),
           ("windowed 2^20", 16, 1 << 20)],
    "g2": [("2^20", 1, 16 * ((1 << 20) + 2)), ("2^18", 1, 16 * ((1 << 18) + 2)),
           ("windowed 2^20", 16, 1 << 20)]}
TAIL_C = 16


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: the kernels' device time under
    torch.profiler over `iters` calls (after a warm-up call), per call.
    Beside the CUDA-event time around a wrapper it tells the card's share
    from the host's at small shapes."""
    fn()
    _, busy, _, _ = profiled(lambda: [fn() for _ in range(iters)])
    return busy / iters


def tail_timing(ops, g, rnd_pts, gen, results) -> None:
    """block_scan, add_gather and abel at the tail's shapes (`TAIL_SHAPES`):
    each entry and its plain version, on the same inputs, timed and
    compared; device time from the profiler beside the CUDA events at the
    small shapes.  For each shape: the bucket ends of a real bucket scan
    (its first column's digits all >= 2^15, so its first 2^15 buckets are
    empty ahead of its first run) filled over the exclusive chunk
    carries; every level of the block scans of the chunk carries and of
    the tree sum over the 2^16 ends at the chooser's shapes, each level
    on the totals of the one before, with the carries' fix-ups; Abel over
    the columns.  An entry's ms / plain_ms / bound_ms / launches sum one
    2^20 prove's tail (`*_2p18`: one 2^18 prove's); the launches must be
    those `tail_launches` gives the path."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import curve_kernels as ck
    from zksnark_tpu_torch.ops import msm

    dev = gen.device
    elem_b = 32 * (1 if g == "g1" else 2)
    pt_b = 3 * elem_b
    cnt_add, cnt_dbl = CountingOps(ops), CountingOps(ops)
    one = rnd_pts(1)
    ck.add_plain(cnt_add, one, rnd_pts(1))
    ck.double_plain(cnt_dbl, one)
    add_ops = cnt_add.muls * MULADDS_PER_MONT_MUL + cnt_add.adds * OPS_PER_ADD
    dbl_ops = cnt_dbl.muls * MULADDS_PER_MONT_MUL + cnt_dbl.adds * OPS_PER_ADD
    add_us = results[f"add_scan_{g}"]["thread_add_us"]
    dbl_us = results[f"add_scan_{g}"]["thread_double_us"]
    c = TAIL_C
    nb = 1 << c

    def err_of(a, b):
        if a is None or b is None:
            return 0 if a is b else 1
        return max(limb_err(u, v) for u, v in zip(a, b))

    def flat(p):
        return jac.JPoint(*(a.reshape((-1,) + a.shape[a.dim()
                                                     - ops.elem_ndim:])
                            for a in p))

    def formula_lanes(p, pi, q, qi):
        """outputs that run the add's formula: both operands finite"""
        fp, fq = flat(p), flat(q)
        fin_p = (pi >= 0) & ~ops.is_zero(fp.z[pi.clamp(min=0).long()])
        fin_q = (qi >= 0) & ~ops.is_zero(fq.z[qi.clamp(min=0).long()])
        return int((fin_p & fin_q).sum().item())

    def gather_bound(p, pi, q, qi):
        n = pi.numel()
        byt = (flat(p).z.shape[0] + flat(q).z.shape[0] + n) * pt_b + 8 * n
        return bound(byt, formula_lanes(p, pi, q, qi) * add_ops)

    def row(label, shape, kern, plain, bnd, iters, small=False, pair=False):
        ms, got = time_cuda(kern, iters)
        plain_ms, want = time_cuda(plain, 1)
        err = (max(err_of(got[0], want[0]), err_of(got[1], want[1]))
               if pair else err_of(got, want))
        out = {"msm": label, "shape": shape, "ms": ms, "plain_ms": plain_ms,
               "err": err, **bnd}
        if small:
            out["device_ms"] = device_ms(kern)
        return out

    def levels(label, level, collect):
        """every block scan level of a (rows, columns) level, and where it
        collects, the fix-ups of its carries"""
        cols = level.z.shape[1]
        scans, gathers = [], []
        while level.z.shape[0] > 1:
            m = level.z.shape[0]
            t, st = ck.block_scan_shape(m, cols)
            blocks = -(-m // (t * st))
            byt = (m * cols * (2 if collect else 1) + blocks * cols) * pt_b
            scans.append(row(
                label, [m, cols, t, st, int(collect)],
                lambda: ck.block_scan(ops, level, collect, t, st),
                lambda: ck.block_scan_plain(ops, level, collect, t, st),
                bound(byt, m * cols * add_ops), 10, small=m * cols <= 4096,
                pair=True))
            scans[-1]["latency_bound_ms"] = (
                (2 * st - 1 if collect else st) + t.bit_length() - 1
            ) * add_us / 1e3
            tot, within = ck.block_scan(ops, level, collect, t, st)
            if collect and blocks > 1:
                bc = msm._prefix_scan(ops, tot)
                i = msm._positions(ops, level, m)
                fpi = (i // (t * st * cols) - 1) * cols + i % cols
                gathers.append(row(
                    label, [m, cols, t * st],
                    lambda: ck.add_gather(ops, bc, fpi, within, i),
                    lambda: ck.add_gather_plain(ops, bc, fpi, within, i),
                    gather_bound(bc, fpi, within, i), 10,
                    small=m * cols <= 4096))
            level = tot
            del within
        return scans, gathers

    scans, gathers, abels, leading = [], [], [], True
    for label, cols, rows in TAIL_SHAPES[g]:
        # the bucket ends
        zm = torch.randint(0, 16, (rows,), device=dev, generator=gen) == 0
        p = rnd_pts(rows)
        tab = jac.JPoint(p.x, p.y, ops.select(
            zm, ops.zero((rows,), dev), ops.one((rows,), dev)).contiguous())
        del p, zm
        digits = torch.randint(0, nb, (cols, rows), device=dev, generator=gen)
        digits[0] |= nb // 2
        d_sorted, order = torch.sort(digits, dim=1)
        del digits
        ends_w, chunk, valid, totals = ck.bucket_scan(
            ops, tab, order, d_sorted, nb, 64, True)
        del tab, d_sorted, order
        b = totals.z.shape[0]
        carry = msm._prefix_scan(ops, msm._cat(
            jac.infinity(ops, (1, cols), dev),
            msm._index(totals, slice(0, b - 1))))
        pi, qi = msm._fill_indices(chunk, valid)
        leading &= bool((pi[:nb // 2, 0] < 0).all())
        gathers.append(row(
            label, [nb, cols],
            lambda: ck.add_gather(ops, carry, pi, ends_w, qi),
            lambda: ck.add_gather_plain(ops, carry, pi, ends_w, qi),
            gather_bound(carry, pi, ends_w, qi), 10))
        del ends_w, chunk, valid, totals, carry, pi, qi

        # the block scans, level by level, and the carries' fix-ups
        for n_rows, collect in ((b, True), (nb, False)):
            s, f = levels(label, jac.JPoint(*(
                a.reshape((n_rows, cols) + a.shape[1:])
                for a in rnd_pts(n_rows * cols))), collect)
            scans += s
            gathers += f

        # Abel
        three = [rnd_pts(cols) for _ in range(3)]
        abels.append(row(label, [cols, c], lambda: ck.abel(ops, *three, c),
                         lambda: ck.abel_plain(ops, *three, c),
                         bound(4 * cols * pt_b,
                               cols * (2 * add_ops + c * dbl_ops)),
                         20, small=True))
        abels[-1]["latency_bound_ms"] = (2 * add_us + c * dbl_us) / 1e3
        want = tail_launches(rows, c, cols)
        for kind, got in (("block_scan", [r for r in scans
                                          if r["msm"] == label]),
                          ("add_gather", [r for r in gathers
                                          if r["msm"] == label])):
            if len(got) != want[kind]:
                raise SystemExit(f"tail_timing {g} {label}: {len(got)} "
                                 f"{kind} rows, the path launches "
                                 f"{want[kind]}")

    for name, rows, extra in (
            (f"block_scan_{g}", scans, {}),
            (f"add_gather_{g}", gathers, {"bucket_ends_leading_empty":
                                          leading}),
            (f"abel_{g}", abels, {})):
        for p in rows:
            log(f"[timing] {name} {p['msm']} {p['shape']}: kernel "
                f"{p['ms']:.4f} ms"
                + (f" (device {p['device_ms']:.4f})" if "device_ms" in p
                   else "")
                + f", plain {p['plain_ms']:.3f} ms, bound "
                f"{p['bound_ms']:.5f} ms ({p['bound_by']})"
                + (f", one thread's chain {p['latency_bound_ms']:.4f} ms"
                   if "latency_bound_ms" in p else "")
                + f"; max |kernel - plain| = {p['err']}")
        big = [p for p in rows if p["msm"] == "2^20"]
        small = [p for p in rows if p["msm"] == "2^18"]
        by = max(big, key=lambda p: p["bound_ms"])["bound_by"]
        results[name].update(
            shape=[p["shape"] for p in big],
            ms=sum(p["ms"] for p in big),
            plain_ms=sum(p["plain_ms"] for p in big),
            bound_ms=sum(p["bound_ms"] for p in big), bound_by=by,
            launches=len(big),
            path_shape_err=max(p["err"] for p in rows),
            checked_shapes=[[p["msm"]] + p["shape"] for p in rows],
            per_shape=rows, ms_2p18=sum(p["ms"] for p in small),
            bound_ms_2p18=sum(p["bound_ms"] for p in small),
            launches_2p18=len(small), **extra)
        log(f"[timing] {name}, summed over one 2^20 prove's tail "
            f"({len(big)} launches): kernel {results[name]['ms']:.4f} ms, "
            f"bound {results[name]['bound_ms']:.5f} ms; one 2^18 prove's "
            f"({len(small)}): kernel {results[name]['ms_2p18']:.4f} ms")
    if not leading:
        raise SystemExit("tail_timing: the first column's leading buckets "
                         "are not empty")


def ptxas_summary(log_text: str) -> list:
    """One line per kernel from nvcc's `-Xptxas -v` output: the kernel
    (its name and template arguments read off the mangled name), its
    registers and its spills."""
    def kernel_name(mangled):
        # the shortest length-prefixed identifier that ends in "kernel" (a
        # length may follow digits of the namespace's hash, and digits of
        # the hash may read as a length: try every split)
        found = [mangled]
        for m in re.finditer(r"\d+", mangled):
            for i in range(m.start(), m.end()):
                size = int(mangled[i:m.end()])
                ident = mangled[m.end():m.end() + size]
                if len(ident) == size and ident.endswith("kernel"):
                    found.append(ident)
        return min(found, key=len)

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
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / INT32_MULADD_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# ---------------------------------------------------------------------------
# reference and path phases
# ---------------------------------------------------------------------------

def _profiling():
    """`utils.profiling`, with the ops modules' launch counters
    registered."""
    from zksnark_tpu_torch.ops import curve_kernels, montmul, ntt  # noqa: F401
    from zksnark_tpu_torch.utils import profiling

    return profiling


def counts() -> dict:
    return _profiling().launch_counts()


def reset_counts() -> None:
    _profiling().reset_launch_counts()


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def reference_phase(dev) -> None:
    """The same small circuit proved on the card and with the plain
    versions on the CPU: the proofs must be equal."""
    from zksnark_tpu_torch.bench import synthetic_square_chain
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


def setup_expect(crs) -> dict:
    """The launches of the single-device `device_setup` that made `crs`:
    per point set one comb launch and one batch_normalize (its prefix and
    suffix scans, `scan_launches` each, and one normalize pass); then the
    window tables of the prove sets (`prover.WindowTables`): one double_n
    launch a block after the first (the three G1 sets side by side) and
    one batch_normalize a set over its W - 1 new blocks; no elementwise
    madd and no elementwise Fq product."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.ops import msm

    tables = crs.sets.tables
    if tables is None:
        raise SystemExit("setup built no window tables")
    new = msm.table_windows(tables.window_bits) - 1
    n1 = [p.z.shape[0] for p in (crs.xi_g1, crs.xi_t_g1, crs.sum_delta_g1)]
    m1, m2 = crs.sets.xi_g1.z.shape[0], crs.sets.xi_g2.z.shape[0]
    return {"comb_g1": 3, "comb_g2": 1, "madd_g1": 0, "madd_g2": 0,
            "mont_scan_fq": sum(2 * jac.scan_launches(n) for n in n1)
            + 3 * 2 * jac.scan_launches(new * m1),
            "mont_scan_fq2": 2 * jac.scan_launches(crs.xi_g2.z.shape[0])
            + 2 * jac.scan_launches(new * m2),
            "normalize_fq": 3 + 3, "normalize_fq2": 1 + 1, "montmul_fq": 0,
            "double_n_g1": new, "double_n_g2": new}


def tail_launches(m: int, c: int = 16, windows: int = 16) -> dict:
    """block_scan and add_gather launches of one MSM over m points with
    `windows` windows of c bits, or of one tail over m table rows with
    `windows` MSMs side by side (`ops/msm.py`, chunks of 64): the chunk
    carries' prefix scan over ceil(m / 64) rows, one block scan a level
    (`block_scan_shape`) and one fix-up add_gather a level below the
    first; the bucket ends' add_gather; the tree sum over 2^c buckets,
    one block scan a level."""
    from zksnark_tpu_torch.ops import curve_kernels as ck

    def levels(n):
        count = 0
        while n > 1:
            t, st = ck.block_scan_shape(n, windows)
            n = -(-n // (t * st))
            count += 1
        return count

    carries = levels(-(-m // 64))
    return {"block_scan": carries + levels(1 << c),
            "add_gather": 1 + max(carries - 1, 0)}


def prove_expect(dqap, crs) -> dict:
    """The launches of one single-device `device_prove` over the CRS's
    window tables (`prover.WindowTables`; four G1 MSMs over W tables of
    max(n + 3, C's points) points, one G2 over W of n + 2: the CRS's
    `prove_sets`): one bucket scan a table (A and C - h - c_delta share
    xi_g1's), then one tail for the four G1 MSMs side by side and one for
    the G2 MSM, each the block scans and add_gathers of `tail_launches`
    over W m rows and one abel; no horner; the NTT kernel once per pass
    of each of the seven transforms; no elementwise madd, add or
    double_n, no add_scan."""
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import msm

    sets = prover.prove_sets(crs)
    if sets.tables is None:
        raise SystemExit("the CRS has no window tables")
    m1, m2 = sets.xi_g1.z.shape[0], sets.xi_g2.z.shape[0]
    c = msm.pick_window_bits(dqap.n)
    w = msm.table_windows(c)
    t1, t2 = tail_launches(w * m1, c, 4), tail_launches(w * m2, c, 1)
    return {"madd_g1": 0, "madd_g2": 0, "add_g1": 0, "add_g2": 0,
            "double_n_g1": 0, "double_n_g2": 0, "add_scan_g1": 0,
            "add_scan_g2": 0, "ntt_fr": 7 * len(dqap.domain.widths),
            "bucket_scan_g1": 3, "bucket_scan_g2": 1,
            "block_scan_g1": t1["block_scan"],
            "block_scan_g2": t2["block_scan"],
            "add_gather_g1": t1["add_gather"],
            "add_gather_g2": t2["add_gather"], "abel_g1": 1, "abel_g2": 1,
            "horner_g1": 0, "horner_g2": 0}


def check_setup(label: str, launches: dict, crs) -> None:
    want = setup_expect(crs)
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong:
        raise SystemExit(f"{label} setup launched {wrong}, expected "
                         f"{ {k: want[k] for k in wrong} }")
    log(f"[{label}] setup launches as expected: {want}")


def same_points(a, b) -> bool:
    return all(torch.equal(x, y)
               for name in ("xi_g1", "xi_t_g1", "sum_delta_g1", "xi_g2")
               for x, y in zip(getattr(a, name), getattr(b, name)))


def path_phase(dev, log_n: int, n_proves: int) -> dict:
    from zksnark_tpu_torch.bench import synthetic_square_chain
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.curve import bn254 as hc
    from zksnark_tpu_torch.field import params
    from zksnark_tpu_torch.groth16 import protocol, prover
    from zksnark_tpu_torch.groth16.backend import BN254Backend
    from zksnark_tpu_torch.utils import serialization as ser

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
    check_setup("path", c_setup, crs)
    expect = prove_expect(dqap, crs)
    log(f"[path] per prove expected: {expect}")

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
                                          "double_n", "horner", "block_scan",
                                          "add_gather", "abel"))
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
                          "peak_gib": peak,
                          "proof": ser.proof_to_json(proof)})
    total = counts()
    peak = max([setup_peak] + [p["peak_gib"] for p in per_prove])
    log(f"[path] launches over setup + {n_proves} proves: {total}; peak "
        f"device memory {peak:.2f} GiB")
    zero = [k for k, v in total.items() if v == 0 and k not in OFF_PATH]
    if zero:
        raise SystemExit(f"kernels never launched on the main path: {zero}")

    tables = table_msm_check(dqap, crs, wit)

    # where setup's time goes: a second setup, each phase ended by a
    # synchronize; it must make the same CRS
    from zksnark_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    t0 = time.time()
    crs2 = prover.device_setup(dqap, trapdoor=(11, 22, 33, 44, 55),
                               timer=timer)
    torch.cuda.synchronize()
    setup2_s = time.time() - t0
    if not same_points(crs, crs2) or crs.sigmag1 != crs2.sigmag1:
        raise SystemExit("path: the timed setup made another CRS")
    del crs2
    log(f"[path] setup breakdown (a second device_setup, each phase ended "
        f"by a synchronize; the same CRS): {setup2_s:.3f} s; "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.phases.items()))
    return {"launches": total, "setup_s": setup_s, "proves": per_prove,
            "setup_phases_s": dict(timer.phases), "setup2_s": setup2_s,
            "peak_gib": peak, "table_check": tables,
            "state": (dqap, crs, wit)}


def table_msm_check(dqap, crs, wit, turns: int = 3) -> dict:
    """The prove's MSMs over the CRS's window tables (`msm_tables`) against
    the windowed formulation (`msm_windowed_batch`, `msm_windowed`) on the
    same sets and scalars: `_prove_core` both ways on one witness and
    blinding, `turns` times in turns, each call ended by a synchronize;
    the five points must be equal in affine form."""
    import dataclasses

    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import msm

    dev = dqap.device
    sets = prover.prove_sets(crs)
    limbs, _, _ = FR_CTX.witness_limbs(wit, dqap.num_wires)
    wm = prover.mont_mul(FR_CTX, torch.from_numpy(limbs).to(dev),
                         FR_CTX.const("r2", dev))
    blind = torch.from_numpy(prover._blinding_limbs(5, 6)).to(dev)
    args = (dqap.domain, dqap.input, msm.pick_window_bits(dqap.n),
            (dqap.u, dqap.v, dqap.w))
    forms = {"tables": sets,
             "windowed": dataclasses.replace(sets, tables=None)}
    ms = {k: [] for k in forms}
    points = {}
    for _ in range(turns):
        for k, s in forms.items():
            torch.cuda.synchronize()
            t0 = time.time()
            points[k] = prover._prove_core(*args, s, wm, blind)
            torch.cuda.synchronize()
            ms[k].append((time.time() - t0) * 1e3)
    equal = [jac.to_affine_np(ops, a) == jac.to_affine_np(ops, b)
             for ops, a, b in zip((FQ_OPS, FQ_OPS, FQ2_OPS, FQ_OPS, FQ_OPS),
                                  points["tables"], points["windowed"])]
    log(f"[path] _prove_core over the window tables / windowed, in turns: "
        f"{[round(t, 2) for t in ms['tables']]} / "
        f"{[round(t, 2) for t in ms['windowed']]} ms; the five points "
        f"equal in affine form: {equal}")
    if not all(equal):
        raise SystemExit("the table MSMs differ from the windowed MSMs")
    return {"ms": ms, "equal": equal}


def keccak_phase(dev, n_bytes: int, n_proves: int) -> dict:
    """The port's example path at full size (`examples/keccak_proof.py`):
    the Keccak-256 preimage circuit built, its witness and R1CS made and
    laid out on the card (each host stage timed), setup with the
    example's trapdoor, then `n_proves` proves with distinct blindings;
    each proof must verify on the digest bits and zero checkers and be
    rejected with a digest bit flipped.  Counts are reset just before
    setup and read after it and after each prove."""
    from zksnark_tpu_torch.examples import keccak_proof as kp
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.groth16 import protocol, prover
    from zksnark_tpu_torch.groth16.backend import BN254Backend
    from zksnark_tpu_torch.utils import keccak_host
    from zksnark_tpu_torch.utils import serialization as ser

    host_s: dict = {}

    def timed(label, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        host_s[label] = time.time() - t0
        log(f"[keccak] {label}: {host_s[label]:.2f} s")
        return out

    pre = kp.preimage_of(n_bytes)
    digest = keccak_host.keccak256(pre)
    c, inst, n_checkers = timed("build (host)", lambda: kp.build(n_bytes))
    weights = timed("witness (host, CircuitInstance.weights)",
                    lambda: inst.weights(kp.bits_of(pre)))
    r1cs = timed("r1cs (host)", inst.r1cs)
    log(f"[keccak] {n_bytes}-byte preimage: {r1cs.num_gates} gates, "
        f"{r1cs.num_wires} wires, {r1cs.input} verify wires")
    dqap = timed("compile_r1cs (host ELL tables, copied to the card)",
                 lambda: prover.compile_r1cs(r1cs, device=dev))
    timed("witness codec to limbs (host)",
          lambda: FR_CTX.witness_limbs(weights, dqap.num_wires))
    timed("witness codec to JSON (host)",
          lambda: ser.witness_to_json(weights))
    public = kp.public_inputs(digest, n_checkers)
    if weights[1:1 + len(public)] != public:
        raise SystemExit("keccak: the circuit's digest wires differ from "
                         "the host Keccak-256")

    # setup's host part grows with the public inputs: sum_gamma is one
    # host G1 scalar multiplication per verify wire and the unity wire
    from zksnark_tpu_torch.curve import bn254 as hc

    t0 = time.time()
    for k in range(8):
        hc.g1_scalar_mul(hc.G1_GEN_PT, FR_CTX.p - 1 - 7 * k)
    smul_s = (time.time() - t0) / 8
    host_s["host G1 scalar multiplication, each"] = smul_s
    log(f"[keccak] host G1 scalar multiplication: {smul_s * 1e3:.1f} ms "
        f"each, x {r1cs.input + 1} for sum_gamma = "
        f"{smul_s * (r1cs.input + 1):.2f} s")

    base = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    crs = prover.device_setup(dqap, trapdoor=kp.TRAPDOOR)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    c_setup = counts()
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[keccak] device_setup n={dqap.n}: {setup_s:.2f} s; launches "
        f"{c_setup}; peak device memory {setup_peak:.2f} GiB (resident "
        f"before it {base:.2f} GiB)")
    check_setup("keccak", c_setup, crs)
    expect = prove_expect(dqap, crs)
    log(f"[keccak] per prove expected: {expect}")
    be = BN254Backend()
    pair = (crs.sigmag1, crs.sigmag2)
    tampered = list(public)
    tampered[0] ^= 1
    per_prove, prev = [], c_setup
    for i in range(n_proves):
        blinding = (kp.BLINDING[0] + i, kp.BLINDING[1] + i)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof = prover.device_prove(dqap, crs, weights, blinding=blinding)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        now = counts()
        launches = diff(now, prev)
        prev = now
        t1 = time.time()
        ok = protocol.verify_fast(be, pair, public, proof)
        verify_s = time.time() - t1
        rej = protocol.verify_fast(be, pair, tampered, proof)
        log(f"[keccak] prove {i} (blinding {blinding}): {ms:.1f} ms; "
            f"launches {launches}; peak device memory {peak:.2f} GiB; "
            f"verify {ok} ({verify_s:.2f} s), tampered digest bit {rej}")
        if not ok or rej:
            raise SystemExit(f"keccak proof {i} failed verification "
                             f"(accept {ok}, tampered accept {rej})")
        wrong = {k: launches[k] for k, v in expect.items()
                 if launches[k] != v}
        if wrong:
            raise SystemExit(f"keccak prove {i} launched {wrong}, expected "
                             f"{ {k: expect[k] for k in wrong} }")
        per_prove.append({"ms": ms, "launches": launches, "peak_gib": peak,
                          "verify_s": verify_s})
    total = counts()
    zero = [k for k, v in total.items() if v == 0 and k not in OFF_PATH]
    if zero:
        raise SystemExit(f"kernels never launched on the keccak path: "
                         f"{zero}")
    summary = {"gates": r1cs.num_gates, "wires": r1cs.num_wires,
               "inputs": r1cs.input, "n": dqap.n, "host_s": host_s,
               "setup_s": setup_s, "setup_peak_gib": setup_peak,
               "prove_ms": [p["ms"] for p in per_prove],
               "prove_peak_gib": [p["peak_gib"] for p in per_prove],
               "verify_s": [p["verify_s"] for p in per_prove],
               "launches_per_prove": per_prove[-1]["launches"]}
    log(f"[keccak] summary {json.dumps(summary)}")
    return {"launches": total, "summary": summary, "proves": per_prove}


# runs a module as `python -m MODULE` does (runpy), then writes the kernel
# launches of its process to stderr: python -c SHIM MODULE ARGS...
MODULE_SHIM = """import json, runpy, sys
from zksnark_tpu_torch.ops import curve_kernels, montmul, ntt  # counters
from zksnark_tpu_torch.utils.profiling import launch_counts
module = sys.argv.pop(1)
sys.argv[0] = module
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
print("LAUNCHES " + json.dumps(launch_counts()), file=sys.stderr)
sys.exit(code)
"""


def run_module(module: str, args: list, timeout: int):
    """(completed process, its kernel launches) of `python -m module
    args` from the checkout's root, through MODULE_SHIM."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    out = subprocess.run([sys.executable, "-c", MODULE_SHIM, module] + args,
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=timeout)
    lines = [ln for ln in out.stderr.splitlines()
             if ln.startswith("LAUNCHES ")]
    if not lines:
        raise SystemExit(f"{module}: no launch counts; stderr:\n"
                         f"{out.stderr[-2000:]}")
    return out, json.loads(lines[-1][len("LAUNCHES "):])


def cli_phase() -> dict:
    """The CLI, one process per command as a user runs it, on
    `simple.zk`: the device flow on the card, setup -> prove
    (--check-witness) -> verify, each exiting 0, and verify with a wrong
    public input exiting 1; setup and prove together must launch every
    kernel of the path.  Then the host flow (--backend host) over BN254
    and over Z251 (--field z251) with the same four steps and exits, and
    `bench --backend host`, which must exit 0 and print one JSON report.
    Each process starts with its counts at 0."""
    # the CRS and proof files go to a scratch directory under the
    # gitignored build directory, removed afterwards
    build_dir = os.path.join(HERE, "zksnark_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        return _cli_steps(work)


def _cli_run(label: str, args: list, want: int) -> tuple:
    t0 = time.time()
    out, launches = run_module("zksnark_tpu_torch.cli", args, 300)
    said = out.stdout.strip().splitlines()
    log(f"[cli] {label}: exit {out.returncode} "
        f"({time.time() - t0:.1f} s): {said[-1] if said else ''}; "
        f"launches {launches}")
    if out.returncode != want:
        raise SystemExit(f"cli {label} exited {out.returncode}, "
                         f"expected {want}; stderr:\n{out.stderr[-2000:]}")
    return out, launches


def _flow(circ: str, crs: str, proof: str, extra: list) -> list:
    return [
        ("setup", ["setup", circ, "--crs", crs] + extra, 0),
        ("prove", ["prove", circ, "--crs", crs, "--inputs", "3,2,4",
                   "--proof", proof, "--check-witness"] + extra, 0),
        ("verify [2, 34]", ["verify", circ, "--crs", crs, "--proof", proof,
                            "--public", "2,34"] + extra, 0),
        ("verify [2, 35]", ["verify", circ, "--crs", crs, "--proof", proof,
                            "--public", "2,35"] + extra, 1),
    ]


def _cli_steps(work: str) -> dict:
    circ = os.path.join(HERE, "test_programs", "simple.zk")
    total = {k: 0 for k in counts()}
    for label, args, want in _flow(circ, os.path.join(work, "crs.json"),
                                   os.path.join(work, "proof.json"), []):
        _, launches = _cli_run(label, args, want)
        for k, v in launches.items():
            total[k] += v
    zero = [k for k, v in total.items() if v == 0 and k not in OFF_PATH]
    if zero:
        raise SystemExit(f"kernels never launched by the CLI: {zero}")
    log(f"[cli] launches over the device flow's four processes: {total}")

    for field in ("bn254", "z251"):
        extra = ["--backend", "host", "--field", field, "--trapdoor",
                 "111,222,333,444,555"]
        for label, args, want in _flow(
                circ, os.path.join(work, f"host_{field}_crs.json"),
                os.path.join(work, f"host_{field}_proof.json"), extra):
            _, launches = _cli_run(f"host {field} {label}", args, want)
            for k, v in launches.items():
                total[k] += v
    out, launches = _cli_run(
        "bench --backend host", ["bench", circ, "--backend", "host",
                                 "--inputs", "3,2,4", "--public", "2,34"], 0)
    text = out.stdout
    report = json.loads(text[text.index("{"):text.rindex("}") + 1])
    if set(report["phases_s"]) != {"setup", "prove", "verify"} or \
            "verify: ACCEPT" not in text:
        raise SystemExit(f"cli bench: unexpected report:\n{text}")
    log(f"[cli] bench --backend host report: {json.dumps(report)}")
    return {"launches": total}


# ---------------------------------------------------------------------------
# the host tier, mont_inv, poly_mul, the bounded MSM and the bench
# ---------------------------------------------------------------------------

HOST_TRAPDOOR = (111, 222, 333, 444, 555)
HOST_BLINDING = (7, 9)
FIELD_N = 1 << 16                # random elements of the mont_inv check
POLY_LOG_N = (20, 10)            # poly_mul: against plain, against dense
BENCH_ARGS = ["--log-n", "20", "--repeats", "2"]


def host_phase(dev) -> dict:
    """The card against the host oracle on `simple.zk`: the port's host
    `protocol.setup` + `prove` (dense-polynomial QAP over the device
    domain's roots) and the card's `device_setup` + `device_prove` with
    the same trapdoor and blinding must give the same proof JSON text,
    and the host CRS the device CRS's host parts (alpha, beta, delta,
    sum_gamma: the 69 G1 / 96 G2 generator scales) and point sets; both
    proofs verify on [2, 34] and are rejected on [2, 35].  Then the same
    circuit through the Z251 mock backend.  Counts are reset just before
    the device setup and read after the device prove."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
    from zksnark_tpu_torch.field.host import FR, Z251
    from zksnark_tpu_torch.frontend import compiler, witness
    from zksnark_tpu_torch.frontend.r1cs import R1CS
    from zksnark_tpu_torch.groth16 import protocol, prover
    from zksnark_tpu_torch.groth16.backend import BN254Backend, Z251Backend
    from zksnark_tpu_torch.groth16.qap import from_r1cs
    from zksnark_tpu_torch.utils import serialization as ser

    stages: dict = {}

    def timed(label, fn):
        t0 = time.time()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stages[label] = time.time() - t0
        log(f"[host] {label}: {stages[label]:.3f} s")
        return out

    code = open(os.path.join(HERE, "test_programs", "simple.zk")).read()
    r1cs = compiler.parse(code, FR)
    w = witness.weights(code, [3, 2, 4], FR)
    reset_counts()
    dq = timed("compile_r1cs (card)", lambda: prover.compile_r1cs(
        r1cs, device=dev))
    dcrs = timed("device_setup (card)", lambda: prover.device_setup(
        dq, trapdoor=HOST_TRAPDOOR))
    dproof = timed("device_prove (card)", lambda: prover.device_prove(
        dq, dcrs, w, blinding=HOST_BLINDING))
    launches = counts()

    roots = prover.domain_roots(dq.domain)
    host_r1cs = R1CS(
        u=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.u],
        v=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.v],
        w=[[(roots[ri - 1], v) for (ri, v) in row] for row in r1cs.w],
        roots=roots, input=r1cs.input)
    be = BN254Backend()
    qap = timed("from_r1cs (host, Lagrange over the domain's roots)",
                lambda: from_r1cs(FR, host_r1cs))
    crs = timed("protocol.setup (host)", lambda: protocol.setup(
        be, qap, trapdoor=HOST_TRAPDOOR))
    hproof = timed("protocol.prove (host)", lambda: protocol.prove(
        be, qap, crs, w, blinding=HOST_BLINDING))
    same_proof = ser.proof_to_json(dproof) == ser.proof_to_json(hproof)
    sg1, sg2 = crs
    parts = {f: getattr(dcrs.sigmag1, f) == getattr(sg1, f)
             for f in ("alpha", "beta", "delta", "sum_gamma")}
    parts.update({f"g2 {f}": getattr(dcrs.sigmag2, f) == getattr(sg2, f)
                  for f in ("beta", "gamma", "delta")})
    xi2 = jac.to_affine_np(FQ2_OPS, dcrs.xi_g2)
    parts.update({
        "xi": list(jac.to_affine_np(FQ_OPS, dcrs.xi_g1)) == sg1.xi,
        "xi_t": list(jac.to_affine_np(FQ_OPS, dcrs.xi_t_g1)) == sg1.xi_t,
        "sum_delta": list(jac.to_affine_np(FQ_OPS, dcrs.sum_delta_g1))
        == sg1.sum_delta,
        "g2 xi": [tuple(map(tuple, p)) if p else None for p in xi2]
        == sg2.xi})
    dpair = (dcrs.sigmag1, dcrs.sigmag2)
    verdicts = {
        "device [2, 34]": protocol.verify(be, dpair, [2, 34], dproof),
        "device [2, 35]": protocol.verify(be, dpair, [2, 35], dproof),
        "host [2, 34]": protocol.verify(be, crs, [2, 34], hproof),
        "host [2, 35]": protocol.verify(be, crs, [2, 35], hproof)}
    log(f"[host] BN254 n={dq.n}: device proof JSON == host proof JSON: "
        f"{same_proof}; CRS parts equal: {parts}; verify {verdicts}")
    if not same_proof or not all(parts.values()):
        raise SystemExit("host: the card's CRS or proof differs from the "
                         "host protocol's")
    if verdicts != {"device [2, 34]": True, "device [2, 35]": False,
                    "host [2, 34]": True, "host [2, 35]": False}:
        raise SystemExit(f"host: wrong verify verdicts {verdicts}")

    zbe = Z251Backend()
    zqap = timed("Z251 from_r1cs", lambda: from_r1cs(
        Z251, compiler.parse(code, Z251)))
    zw = witness.weights(code, [3, 2, 4], Z251)
    zcrs = timed("Z251 setup", lambda: protocol.setup(
        zbe, zqap, trapdoor=HOST_TRAPDOOR))
    zproof = timed("Z251 prove", lambda: protocol.prove(
        zbe, zqap, zcrs, zw, blinding=HOST_BLINDING))
    zv = (protocol.verify(zbe, zcrs, [2, 34], zproof),
          protocol.verify(zbe, zcrs, [2, 35], zproof))
    log(f"[host] Z251: proof {ser.proof_to_json(zproof)}; verify [2, 34] "
        f"{zv[0]}, [2, 35] {zv[1]}")
    if zv != (True, False):
        raise SystemExit(f"host: Z251 verify verdicts {zv}")
    return {"launches": launches, "stages_s": stages}


def field_phase(dev, seed: int) -> dict:
    """mont_inv on the card, Fr and Fq: 2^16 random elements plus 0, 1
    and p - 1, bit-exact against the plain version on the card and equal
    to pow(x, p - 2, p) on the host (zero to zero).  Counts are reset
    just before each field's first call and read after it."""
    from zksnark_tpu_torch.field import limb
    from zksnark_tpu_torch.field.limb import FQ_CTX, FR_CTX
    from zksnark_tpu_torch.ops import montmul as mm

    rng = np.random.default_rng(seed)
    launches = {k: 0 for k in counts()}
    out = {}
    for ctx, name in ((FR_CTX, "fr"), (FQ_CTX, "fq")):
        p = ctx.p
        vals = [0, 1, p - 1] + list(rand_field(rng, p, (FIELD_N,)))
        x = torch.from_numpy(ctx.to_mont_np(vals)).to(dev)
        reset_counts()
        got = mm.mont_inv(ctx, x)
        torch.cuda.synchronize()
        per_call = counts()
        for k, v in per_call.items():
            launches[k] += v
        n_launch = per_call[f"montmul_{name}"]
        want = limb.mont_inv(ctx, x)
        err = limb_err(got, want)
        host = ctx.from_mont_np(got.cpu().numpy())
        host_ok = all(int(h) == pow(v, p - 2, p) for h, v in zip(host, vals))
        zero_ok = int(host[0]) == 0 and not bool(got[0].any())
        ms, _ = time_cuda(lambda: mm.mont_inv(ctx, x), 5)
        plain_ms, _ = time_cuda(lambda: limb.mont_inv(ctx, x), 1)
        wall, busy, _, _ = profiled(lambda: mm.mont_inv(ctx, x))
        out[name] = {"n": len(vals), "launches_per_call": n_launch,
                     "max_abs_err": err, "host_ok": host_ok,
                     "zero_ok": zero_ok, "ms": ms, "plain_ms": plain_ms,
                     "profiled_wall_ms": wall, "device_busy_ms": busy}
        log(f"[field] mont_inv {name}: {len(vals)} elements, {n_launch} "
            f"montmul launches per call, {ms:.3f} ms per call (plain "
            f"{plain_ms:.1f} ms; one call profiled: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms); max |kernel - plain| = {err}; "
            f"pow(x, p-2) on the host {'ok' if host_ok else 'FAIL'}; 0 -> 0 "
            f"{'ok' if zero_ok else 'FAIL'}")
        bits = ctx.p_minus_2_bits
        if dev.type == "cuda" and n_launch != len(bits) + sum(bits):
            raise SystemExit(f"field: mont_inv {name} launched {n_launch} "
                             f"products, expected {len(bits) + sum(bits)}")
        if err or not host_ok or not zero_ok:
            raise SystemExit(f"field: mont_inv {name} is wrong")
    return {"launches": launches, "mont_inv": out}


def _rand_limbs(dev, gen, n: int) -> torch.Tensor:
    """n random canonical residues (< 2^252 < p) as limbs on the card."""
    t = torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int64,
                      device=dev, generator=gen)
    t[:, 7] &= 0x0FFFFFFF
    return t.to(torch.int32)


def _poly_mul_plain(domain, a, b):
    """`ntt.poly_mul` with the plain NTT passes and products."""
    from zksnark_tpu_torch.field import limb
    from zksnark_tpu_torch.ops import ntt

    def fwd(x, tw):
        return ntt.butterflies_plain(domain.ctx, domain.log_n, tw, x,
                                     domain.widths)

    prod = limb.mont_mul(domain.ctx, fwd(a, domain.t.tw_table),
                         fwd(b, domain.t.tw_table))
    return limb.mont_mul(domain.ctx, fwd(prod, domain.t.tw_table_inv),
                         domain.t.n_inv_mont.unsqueeze(0))


def poly_mul_phase(dev, seed: int) -> dict:
    """`ntt.poly_mul` on the card: at n = 2^20, two random polynomials of
    degree < 2^19, bit-exact against the plain version on the card; at
    n = 2^10, two of degree < 2^9 against the host `dense.mul`.  Counts
    are reset just before the 2^20 product and read after it."""
    from zksnark_tpu_torch.field.host import FR
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.ops import ntt
    from zksnark_tpu_torch.poly import dense

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    big, small_log = POLY_LOG_N
    n = 1 << big
    d20 = ntt.get_domain(big, dev)
    zeros = torch.zeros((n // 2, 8), dtype=torch.int32, device=dev)
    a = torch.cat([_rand_limbs(dev, gen, n // 2), zeros])
    b = torch.cat([_rand_limbs(dev, gen, n // 2), zeros])
    reset_counts()
    got = ntt.poly_mul(d20, a, b)
    torch.cuda.synchronize()
    launches = counts()
    ms, _ = time_cuda(lambda: ntt.poly_mul(d20, a, b), 10)
    plain_ms, want = time_cuda(lambda: _poly_mul_plain(d20, a, b), 1)
    err = limb_err(got, want)
    log(f"[poly_mul] n=2^{big}, degrees < 2^{big - 1}: {ms:.3f} ms per "
        f"product (plain {plain_ms:.1f} ms); launches {launches}; max "
        f"|kernel - plain| = {err}")

    rng = np.random.default_rng(seed)
    m = 1 << small_log
    pa = list(rand_field(rng, FR.p, (m // 2,))) + [0] * (m // 2)
    pb = list(rand_field(rng, FR.p, (m // 2,))) + [0] * (m // 2)
    d10 = ntt.get_domain(small_log, dev)
    small = ntt.poly_mul(
        d10, torch.from_numpy(FR_CTX.to_mont_np(pa)).to(dev),
        torch.from_numpy(FR_CTX.to_mont_np(pb)).to(dev))
    host = [int(v) for v in FR_CTX.from_mont_np(small.cpu().numpy())]
    want_small = dense.mul(FR, pa, pb)
    dense_ok = host == want_small + [0] * (m - len(want_small))
    log(f"[poly_mul] n=2^{small_log}, degrees < 2^{small_log - 1}: equal "
        f"to the host dense.mul: "
        f"{dense_ok}")
    if err or not dense_ok:
        raise SystemExit("poly_mul: the card's product is wrong")
    # three transforms, the pointwise product and the n^-1 product
    want_l = {"ntt_fr": 3 * len(d20.widths), "montmul_fr": 2}
    if dev.type == "cuda" and any(launches[k] != v for k, v in want_l.items()):
        raise SystemExit(f"poly_mul launched {launches}, expected {want_l}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err}


@contextlib.contextmanager
def point_ops_plain():
    """Route every point op of `ops.curve_kernels` to its plain version on
    CUDA tensors too, for the duration: the module's `_device` switch,
    which each of its wrappers asks (madd, add, double, the chains
    bucket_scan, add_scan, double_n, horner, comb and the tail's
    block_scan, add_gather and abel), answers "cpu".  It reroutes
    nothing else: field products through `ops.montmul` and the NTT still
    launch their kernels, so a caller checks the counts.  An MSM over
    FQ_OPS (plain limb products) launches none."""
    from zksnark_tpu_torch.ops import curve_kernels as ck

    saved = ck._device
    ck._device = lambda p, op: "cpu"
    try:
        yield
    finally:
        ck._device = saved


def msm_bits_phase(dev, xi_g1, seed: int) -> dict:
    """`msm(..., scalar_bits=64)` over 2^20 G1 CRS points (the path's
    xi_g1) with 64-bit scalars: equal in affine form to the full
    16-window MSM, with one bucket-scan launch at W = 4; and bit-exact
    against its plain version on the card at the same shape.  Counts are
    reset just before the bounded MSM and read after it."""
    from zksnark_tpu_torch.curve import jacobian as jac
    from zksnark_tpu_torch.curve.field_ops import FQ_OPS
    from zksnark_tpu_torch.ops import msm

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = xi_g1.z.shape[0]
    s = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    s[:, :2] = torch.randint(-(1 << 31), 1 << 31, (n, 2), dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)
    c = msm.pick_window_bits(n)
    n_win = msm._digit_columns(s[:1], c, 64).shape[0]
    reset_counts()
    got = msm.msm(FQ_OPS, xi_g1, s, scalar_bits=64, affine=True)
    torch.cuda.synchronize()
    launches = counts()
    full = msm.msm(FQ_OPS, xi_g1, s, affine=True)
    torch.cuda.synchronize()
    full_launches = diff(counts(), launches)
    same = jac.to_affine_np(FQ_OPS, got) == jac.to_affine_np(FQ_OPS, full)
    ms, _ = time_cuda(lambda: msm.msm(FQ_OPS, xi_g1, s, scalar_bits=64,
                                      affine=True), 5)
    full_ms, _ = time_cuda(lambda: msm.msm(FQ_OPS, xi_g1, s, affine=True), 5)
    breakdown = {}
    for label, bound_bits in (("scalar_bits=64", 64), ("full", 0)):
        wall, busy, rows, _ = profiled(lambda: msm.msm(
            FQ_OPS, xi_g1, s, scalar_bits=bound_bits, affine=True))
        breakdown[label] = {"wall_ms": wall, "device_busy_ms": busy,
                            "top": [list(r) for r in rows[:8]]}
        log(f"[msm_bits] {label} under the profiler: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms; by kernel: " + "; ".join(
                f"{k[:48]} {t:.3f} ms x{cnt}" for k, t, cnt in rows[:8]))
    log(f"[msm_bits] n={n}, c={c}: scalar_bits=64 {ms:.3f} ms (W = "
        f"{n_win}, bucket-scan launches {launches['bucket_scan_g1']}), full "
        f"{full_ms:.3f} ms (W = {-(-256 // c)}, bucket-scan launches "
        f"{full_launches['bucket_scan_g1']}); equal in affine form: {same}")

    # the plain version at this path's own shape (2^20 points, c = 16,
    # W = 4): the same MSM, points and scalars with every point op on its
    # plain version; it must launch nothing and equal the kernels' result
    # bit for bit, in raw Jacobian coordinates
    reset_counts()
    t0 = time.time()
    with point_ops_plain():
        plain = msm.msm(FQ_OPS, xi_g1, s, scalar_bits=64, affine=True)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    stray = {k: v for k, v in counts().items() if v}
    err = max(limb_err(a, b) for a, b in zip(got, plain))
    log(f"[msm_bits] n={n}, c={c}, W = {n_win}: max |kernel - plain| = "
        f"{err} (plain on the card {plain_ms:.1f} ms, kernel launches in "
        f"it {stray or 0})")
    tl = tail_launches(n, c, n_win)
    tail = {"bucket_scan_g1": 1, "block_scan_g1": tl["block_scan"],
            "add_gather_g1": tl["add_gather"], "add_scan_g1": 0,
            "abel_g1": 1, "add_g1": 0, "double_n_g1": 0}
    if not same or err or stray or n_win != -(-64 // c) or (
            dev.type == "cuda" and any(launches[k] != v
                                       for k, v in tail.items())):
        raise SystemExit("msm_bits: the bounded MSM is wrong")
    return {"launches": launches, "ms": ms, "full_ms": full_ms,
            "plain_ms": plain_ms, "windows": n_win,
            "full_launches": full_launches, "max_abs_err": err,
            "profile": breakdown}


def bench_phase() -> dict:
    """`python -m zksnark_tpu_torch.bench --log-n 20 --repeats 2` in its
    own process: its last line must be the headline, with a value > 0,
    and its details must say the proof verified."""
    details = os.path.join(HERE, "chiprun_out", "bench_details.json")
    t0 = time.time()
    out, launches = run_module("zksnark_tpu_torch.bench",
                               BENCH_ARGS + ["--details", details], 900)
    wall = time.time() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise SystemExit(f"bench exited {out.returncode}; stderr:\n"
                         f"{out.stderr[-3000:]}")
    head = json.loads(lines[-1])
    with open(details) as f:
        det = json.load(f)
    log(f"[bench] headline {lines[-1]}")
    log(f"[bench] details {json.dumps(det)}")
    log(f"[bench] process {wall:.1f} s; launches {launches}")
    if not head.get("metric", "").startswith("groth16_prove_2^") or \
            not head.get("value", 0) > 0 or det.get("proof_verified") is not True:
        raise SystemExit("bench: no verified headline")
    return {"launches": launches, "headline": head, "details": det}


# one rank of the mesh path: python -c MESH_RANK BACKEND WORLD RANK LOG_N
# PORT N_PROVES.  Builds the square chain and the comb tables (timed
# apart, as [path] does), runs device_setup(mesh=) and N_PROVES
# device_prove(mesh=) with the blindings of [path] on cuda:0, each prove
# started by all ranks together (a barrier), writes its kernel launches
# to stderr after setup and after each prove (counts reset just before
# each), verifies the proofs on rank 0 after the last prove, and prints
# one JSON line last on stdout.
MESH_RANK = """import json, sys, time
import torch
import torch.distributed as dist
from zksnark_tpu_torch.bench import synthetic_square_chain
from zksnark_tpu_torch.curve import bn254 as hc
from zksnark_tpu_torch.curve.field_ops import FQ2_OPS, FQ_OPS
from zksnark_tpu_torch.field import params
from zksnark_tpu_torch.groth16 import protocol, prover
from zksnark_tpu_torch.groth16.backend import BN254Backend
from zksnark_tpu_torch.ops import curve_kernels, montmul, ntt  # counters
from zksnark_tpu_torch.parallel import multihost
from zksnark_tpu_torch.utils import profiling
from zksnark_tpu_torch.utils.serialization import proof_to_json

backend = sys.argv[1]
world, rank, log_n, port, n_proves = map(int, sys.argv[2:7])


def report(label):
    print("LAUNCHES " + label + " " + json.dumps(profiling.launch_counts()),
          file=sys.stderr, flush=True)
    profiling.reset_launch_counts()


multihost.init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           backend=backend, device="cuda:0")
mesh = multihost.global_mesh()
t0 = time.time()
r1cs, wit = synthetic_square_chain((1 << log_n) - 1)
dqap = prover.compile_r1cs(r1cs)
torch.cuda.synchronize()
out = {"rank": rank, "host_s": time.time() - t0}
t0 = time.time()
for ops, base in (
        (FQ_OPS, hc.g1_scalar_mul(hc.G1_GEN_PT, params.ENCRYPT_G1_SCALE)),
        (FQ2_OPS, hc.g2_scalar_mul(hc.G2_GEN, params.ENCRYPT_G2_SCALE))):
    prover._comb_table(ops, base, dqap.device)
torch.cuda.synchronize()
out["comb_s"] = time.time() - t0
report("circuit")
torch.cuda.reset_peak_memory_stats()
t0 = time.time()
crs = prover.device_setup(dqap, trapdoor=(11, 22, 33, 44, 55), mesh=mesh)
torch.cuda.synchronize()
out["setup_s"] = time.time() - t0
out["setup_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
report("setup")
be = BN254Backend()
pair = (crs.sigmag1, crs.sigmag2)
for key in ("prove_ms", "peak_gib", "proofs", "verify"):
    out[key] = []
proofs = []
for i in range(n_proves):
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.time()
    proof = prover.device_prove(dqap, crs, wit, blinding=(7 + i, 9 + i),
                                mesh=mesh)
    torch.cuda.synchronize()
    out["prove_ms"].append((time.time() - t0) * 1e3)
    out["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
    report(f"prove{i}")
    proofs.append(proof)
    out["proofs"].append(proof_to_json(proof))
if rank == 0:
    out["verify"] = [[protocol.verify(be, pair, [wit[1]], p),
                      protocol.verify(be, pair, [wit[1] + 1], p)]
                     for p in proofs]
dist.destroy_process_group()
print(json.dumps(out), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_run(backend: str, world: int, log_n: int, want: list) -> dict:
    """One mesh run of `world` rank processes (MESH_RANK), each proof held
    to `want` (the single-device proofs' JSON); returns rank 0's numbers
    and every rank's launches."""
    from zksnark_tpu_torch.ops import msm, ntt
    from zksnark_tpu_torch.parallel import prove_sharded as psh

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    port = free_port()
    label = f"{backend} d={world} n=2^{log_n}"
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_RANK, backend, str(world), str(r),
         str(log_n), str(port), str(len(want))],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    # a rank that fails leaves the others waiting in a collective: kill
    # them all as soon as one fails, or at the time limit
    with ThreadPoolExecutor(world) as pool:
        reads = [pool.submit(p.communicate) for p in procs]
        while not all(f.done() for f in reads):
            if time.time() - t0 > 600 or any(
                    p.poll() not in (None, 0) for p in procs):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            wait(reads, timeout=0.5, return_when=FIRST_COMPLETED)
        outs = [f.result() for f in reads]
    wall = time.time() - t0
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        # the rank that failed first, not one killed for waiting on it
        r = min(failed, key=lambda r: procs[r].returncode == -9)
        raise SystemExit(f"mesh {label}: rank {r} exited "
                         f"{procs[r].returncode} after {wall:.0f} s; "
                         f"stderr:\n{outs[r][1][-3000:]}")
    split = psh.four_step_split(log_n, world)
    passes = sum(len(ntt.pass_widths(k)) for k in split)
    # per MSM a rank runs n / world points, and the blinding's 3 (A and
    # C - h - c_delta) or 2 (B) appended
    per = (1 << log_n) // world
    c = msm.pick_window_bits(1 << log_n)
    w = -(-256 // c)
    t3, t0, t2 = (tail_launches(per + 3, c, w), tail_launches(per, c, w),
                  tail_launches(per + 2, c, w))
    # the ranks' partial sums: one more tree-sum level an MSM
    joint = int(world > 1)
    expect = {"bucket_scan_g1": 4, "bucket_scan_g2": 1, "madd_g1": 0,
              "madd_g2": 0, "add_g1": 0, "add_g2": 0, "double_n_g1": 0,
              "double_n_g2": 0, "add_scan_g1": 0, "add_scan_g2": 0,
              "block_scan_g1": 2 * (t3["block_scan"] + t0["block_scan"])
              + 4 * joint,
              "block_scan_g2": t2["block_scan"] + joint,
              "add_gather_g1": 2 * (t3["add_gather"] + t0["add_gather"]),
              "add_gather_g2": t2["add_gather"], "abel_g1": 4,
              "abel_g2": 1,
              "ntt_fr": 0, "ntt_fr_batched": 7 * passes}
    log(f"[mesh] {label}: per prove and rank expected {expect}")
    ranks = []
    for r, (out, err) in enumerate(outs):
        res = json.loads(out.strip().splitlines()[-1])
        launches = {}
        for ln in err.splitlines():
            if ln.startswith("LAUNCHES "):
                _, phase, body = ln.split(" ", 2)
                launches[phase] = json.loads(body)
        total = {k: launches["setup"][k] + sum(
            launches[f"prove{i}"][k] for i in range(len(want)))
            for k in launches["setup"]}
        res.update(launches=launches, total=total)
        for i, proof in enumerate(res["proofs"]):
            if proof != want[i]:
                raise SystemExit(f"mesh {label}: rank {r} proof {i} differs "
                                 f"from the single-device proof")
            got = launches[f"prove{i}"]
            wrong = {k: got[k] for k, v in expect.items() if got[k] != v}
            if wrong or not all(got[k] > 0 for k in (
                    "horner_g1", "horner_g2", "montmul_fr")):
                raise SystemExit(f"mesh {label}: rank {r} prove {i} "
                                 f"launched {got}, expected {expect} and "
                                 f"horner, montmul_fr > 0")
        zero = [k for k, v in total.items()
                if v == 0 and k not in MESH_OFF_PATH]
        if zero:
            raise SystemExit(f"mesh {label}: rank {r} never launched {zero}")
        log(f"[mesh] {label} rank {r}: host circuit {res['host_s']:.2f} s, "
            f"comb tables {res['comb_s']:.2f} s, "
            f"setup {res['setup_s']:.2f} s (peak {res['setup_peak_gib']:.2f}"
            f" GiB), prove ms {[round(t, 1) for t in res['prove_ms']]} (peak"
            f" GiB {[round(g, 2) for g in res['peak_gib']]}); launches per "
            f"prove {launches['prove0']}")
        ranks.append(res)
    if len(ranks[0]["verify"]) != len(want) or \
            any(not ok or bad for ok, bad in ranks[0]["verify"]):
        raise SystemExit(f"mesh {label}: verify [x], [x+1] gave "
                         f"{ranks[0]['verify']}")
    n = 1 << log_n
    log(f"[mesh] {label}: {world} ranks, proofs byte-equal to the single-"
        f"device proofs, verify [x] True, [x+1] False; {wall:.1f} s of "
        f"wall; per prove and rank 7 all-to-alls of {n * 32 // world} B "
        f"and 5 all-gathers of {world} points")
    return {"backend": backend, "world": world, "log_n": log_n,
            "wall_s": wall, "split": list(split),
            "setup_s": [r["setup_s"] for r in ranks],
            "prove_ms": [r["prove_ms"] for r in ranks],
            "peak_gib": [max([r["setup_peak_gib"]] + r["peak_gib"])
                         for r in ranks],
            "launches_per_prove": [r["launches"]["prove0"] for r in ranks],
            "launches": ranks[0]["total"]}


def single_proofs(dev, log_n: int, n_proves: int) -> list:
    """The single-device proofs of the square chain at 2^log_n with the
    trapdoor and blindings of [path] and the mesh runs."""
    from zksnark_tpu_torch.bench import synthetic_square_chain
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.utils import serialization as ser

    t0 = time.time()
    r1cs, wit = synthetic_square_chain((1 << log_n) - 1)
    dqap = prover.compile_r1cs(r1cs, device=dev)
    crs = prover.device_setup(dqap, trapdoor=(11, 22, 33, 44, 55))
    out, ms = [], []
    for i in range(n_proves):
        t1 = time.time()
        out.append(ser.proof_to_json(prover.device_prove(
            dqap, crs, wit, blinding=(7 + i, 9 + i))))
        torch.cuda.synchronize()
        ms.append((time.time() - t1) * 1e3)
    log(f"[mesh] single-device reference at n=2^{log_n}: "
        f"{time.time() - t0:.1f} s, prove ms {[round(t, 1) for t in ms]}")
    del dqap, crs
    torch.cuda.empty_cache()
    return out, ms


# the mesh runs: (backend, world size, log n); NCCL takes one rank per
# card, so the card runs it at world size 1, and gloo puts 2 and 4 ranks
# on the same card
MESH_RUNS = [("nccl", 1, 20), ("gloo", 2, 18), ("gloo", 4, 18)]


def mesh_phase(dev, path_proofs: list) -> dict:
    """The mesh runs of MESH_RUNS, each against the single-device proofs
    at its n ([path]'s at 2^20)."""
    runs, refs = [], {20: (path_proofs[:2], None)}
    for backend, world, log_n in MESH_RUNS:
        if log_n not in refs:
            refs[log_n] = single_proofs(dev, log_n, 2)
        runs.append(mesh_run(backend, world, log_n, refs[log_n][0]))
    return {"launches": runs[0]["launches"], "runs": runs,
            "single_prove_ms": {k: v[1] for k, v in refs.items() if v[1]}}


def profiled(fn) -> tuple:
    """One call of `fn` under torch.profiler: (wall ms, ended by a
    synchronize; device busy ms; (kernel name, device ms, count) rows by
    device time; the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device activities only; "Command Buffer Full" is CUPTI's record of
    # the host waiting for a full launch queue, not device work
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))
                   and not e.key.startswith("Command Buffer Full")),
                  key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows, prof


def profile_phase(dqap, crs, wit, table_path: str) -> None:
    """Where a prove's time goes: its stages timed one by one (each ends
    in a synchronize), then one whole setup and one whole prove under
    torch.profiler (device time by kernel, and the device's idle share of
    the wall time).  The prove's full profiler table is written to
    `table_path`."""
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
    sets = prover.prove_sets(crs)
    blind = torch.from_numpy(prover._blinding_limbs(5, 6)).to(dev)
    a_s, c_s, b_s = timed("blinded scalars (s u + r v)",
                          lambda: prover._blinded_scalars(u, v, blind))
    m = sets.xi_g1.z.shape[0]
    wb = msm.pick_window_bits(n)

    def pad(*parts):
        ss = torch.cat(parts)
        return torch.cat([ss, ss.new_zeros((m - ss.shape[0], ss.shape[1]))])

    tables = sets.tables
    timed("msm G1 A, C', H, C over the window tables (one tail)",
          lambda: msm.msm_tables(FQ_OPS, [
              (tables.g1_table(0), [pad(*a_s), pad(*c_s)]),
              (tables.g1_table(1), [pad(h[:n - 1])]),
              (tables.g1_table(2), [pad(tail)])], wb))
    timed("msm G2 B (v | 1, s) over its window table",
          lambda: msm.msm_tables(FQ2_OPS, [
              (tables.g2_table(), [torch.cat(b_s)])], wb))

    wall_ms, busy_ms, rows, _ = profiled(
        lambda: prover.device_setup(dqap, trapdoor=(11, 22, 33, 44, 55)))
    log(f"[profile] one setup under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for key, ms, count in rows[:10]:
        log(f"[profile]   {ms:9.2f} ms {count:6d}x  {key[:90]}")

    wall_ms, busy_ms, rows, prof = profiled(
        lambda: prover.device_prove(dqap, crs, wit, blinding=(5, 6)))
    log(f"[profile] one prove under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for key, ms, count in rows[:12]:
        log(f"[profile]   {ms:9.2f} ms {count:6d}x  {key[:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))


# the wide rows of `sprout_path-d29`'s layout (u, v, w): {row width: rows},
# the rows that `groth16.prover.narrow_width` leaves out of each ELL
# (k0 = 2, 2, 1) at n = 2^20; 1,380,540 non-zeros in all
WIDE_SHAPES = {
    "u": {3: 1189, 4: 57971},
    "v": {3: 1712, 4: 203, 5: 57072, 32: 15776, 33: 232, 34: 1392,
          35: 3712, 253: 1},
    "w": {2: 67048, 4: 1392, 6: 1856, 7: 1856},
}
WIDE_N = 1 << 20
# the wide rows of `poseidon_insert-d30`'s layout (k0 = 1, 1, 1 at n =
# 2^20; 24,062,526 non-zeros, S-box inputs of 2-61 full-width terms): the
# group of u and v is 8 (`prover._wide_group(61)`), of w 1
POSEIDON_WIDE_SHAPES = {
    "poseidon_u": {2: 64, 3: 3904, 4: 72960, 5: 7552,
                   **{k: 3840 for k in range(6, 61)}, 61: 11520},
    "poseidon_v": {2: 2112, 3: 7873, 4: 149632, 5: 15104,
                   **{k: 7680 for k in range(6, 61)}, 30: 7744,
                   61: 23040},
    "poseidon_w": {2: 63, 3: 63},
}


def np_limbs(gen, n: int) -> torch.Tensor:
    """n random Fr limbs below p from a numpy generator (the top limb's
    high bits cleared)."""
    a = gen.integers(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    a[:, 7] &= 0x0FFFFFFF
    return torch.from_numpy(a.view(np.int32))


def wide_csr(gen, dev, widths: dict, n: int, n_wires: int):
    """A random CSR matrix with the rows `widths` ({width: rows}) in a
    domain of n rows, laid out as `compile_r1cs` lays out wide rows
    (longest first): (idx, val, ptr, rows, group)."""
    from zksnark_tpu_torch.groth16 import prover

    lens = np.array(sorted((k for k, c in widths.items() for _ in range(c)),
                           reverse=True), dtype=np.int64)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    rows = np.sort(gen.choice(n, lens.shape[0], replace=False))
    gen.shuffle(rows)
    nnz = int(ptr[-1])
    return (torch.from_numpy(gen.integers(0, n_wires, nnz).astype(
                np.int32)).to(dev),
            np_limbs(gen, nnz).to(dev),
            torch.from_numpy(ptr).to(dev),
            torch.from_numpy(rows).to(dev),
            prover._wide_group(int(lens[0])))


def wide_phase(dev, seed: int, results: dict) -> None:
    """The wide rows' kernel (`ops.montmul.wide_rows`) against its plain
    version, bit for bit: edge rows (zero, one and p - 1 values and
    witness elements, one-term rows, a row of 300 terms, a repeated wire)
    at every group size, then each matrix of `sprout_path-d29`'s wide rows
    (`WIDE_SHAPES`) at n = 2^20 over random values, timed with CUDA
    events beside the plain version and the bound (4 B index + 32 B value
    + 32 B witness element a term, 32 B a row; one product and one add a
    term)."""
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.ops import montmul

    gen = np.random.default_rng(seed + 15)
    p = FR_CTX.p
    edge = [0, 1, p - 1, FR_CTX.r_int % p, 2]
    w = torch.from_numpy(FR_CTX.to_limbs_np(edge * 40)).to(dev)
    lens = np.array([1, 1, 300, 2, 5, 33, 1], dtype=np.int64)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    nnz = int(ptr[-1])
    idx = torch.from_numpy(gen.integers(0, w.shape[0], nnz).astype(
        np.int32)).to(dev)
    idx[3:10] = 7                                # one wire repeated
    val = torch.from_numpy(FR_CTX.to_limbs_np(
        [edge[i % 5] for i in range(nnz)])).to(dev)
    rows = torch.tensor([5, 0, 17, 9, 3, 30, 31], device=dev)
    ptr_t = torch.from_numpy(ptr).to(dev)
    out0 = torch.from_numpy(FR_CTX.to_limbs_np([3] * 32)).to(dev)
    want = montmul.wide_rows_plain(w, idx, val, ptr_t, rows, out0.clone())
    edge_err = max(
        limb_err(montmul.wide_rows(w, idx, val, ptr_t, rows, out0.clone(), g),
                 want)
        for g in (1, 2, 4, 8, 16, 32))
    # the host: row 2 (300 terms) as ints
    w_int = FR_CTX.from_limbs_np(w.cpu().numpy())
    v_int = FR_CTX.from_limbs_np(val.cpu().numpy())
    r_inv = pow(2, -256, p)
    host = sum(int(v_int[j]) * int(w_int[int(idx[j])]) * r_inv
               for j in range(ptr[2], ptr[3])) % p
    host_ok = int(FR_CTX.from_limbs_np(want[17].cpu().numpy())) == host
    log(f"[wide] edge rows at g = 1 .. 32: err against the plain version "
        f"{edge_err}, the 300-term row equal to host ints {host_ok}")

    per_shape = {}
    err = 0
    for name, widths in {**WIDE_SHAPES, **POSEIDON_WIDE_SHAPES}.items():
        idx, val, ptr_t, rows, g = wide_csr(gen, dev, widths, WIDE_N, WIDE_N)
        wv = np_limbs(gen, WIDE_N).to(dev)
        out = torch.zeros((WIDE_N, 8), dtype=torch.int32, device=dev)
        ms, got = time_cuda(lambda: montmul.wide_rows(
            wv, idx, val, ptr_t, rows, out, g), 20)
        got = got.clone()
        plain_ms, ref = time_once(lambda: montmul.wide_rows_plain(
            wv, idx, val, ptr_t, rows, torch.zeros_like(out)))
        err = max(err, limb_err(got, ref))
        nz, nr = idx.shape[0], rows.shape[0]
        bnd = bound(nz * (4 + 64) + nr * 32, nz * (MULADDS_PER_MONT_MUL + 16))
        per_shape[name] = {"rows": nr, "nnz": nz, "group": g, "ms": ms,
                           "plain_ms": plain_ms, **bnd}
        log(f"[wide] {name}: {nr} rows, {nz} non-zeros, g = {g}: "
            f"{ms:.4f} ms (bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']}, {100 * bnd['bound_ms'] / ms:.1f} %), "
            f"plain {plain_ms:.2f} ms, err {limb_err(got, ref)}")
    for cell, names in (("sprout_path-d29", WIDE_SHAPES),
                        ("poseidon_insert-d30", POSEIDON_WIDE_SHAPES)):
        total = {k: sum(per_shape[m][k] for m in names)
                 for k in ("ms", "plain_ms", "bound_ms", "nnz", "rows")}
        log(f"[wide] {cell}: a prove's three launches {total['ms']:.4f} "
            f"ms, bound {total['bound_ms']:.4f} ms, plain "
            f"{total['plain_ms']:.2f} ms")
    total = {k: sum(per_shape[m][k] for m in WIDE_SHAPES)
             for k in ("ms", "plain_ms", "bound_ms")}
    order_equal = evals_order_check(dev, gen, WIDE_N)
    log(f"[wide] the ELL sums, then the wide rows (the prove's order) "
        f"against each matrix in turn, through the quotient at n = "
        f"{WIDE_N}: equal {order_equal}")
    err = max(err, int(not order_equal))
    results["wide_rows_fr"] = {
        "bit_exact": edge_err == 0, "host_edge_ok": host_ok,
        "max_abs_err": edge_err, "path_shape_err": err,
        "order_equal": order_equal,
        "checked_shapes": list(WIDE_SHAPES) + list(POSEIDON_WIDE_SHAPES),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "/".join(sorted({v["bound_by"]
                                     for v in per_shape.values()})),
        "shape": "sprout_path-d29 wide rows", "per_shape": per_shape}


def evals_order_check(dev, gen, n: int) -> bool:
    """`_witness_quotient` (the three ELL sums, then the three wide-row
    kernels) against the evaluations made a matrix at a time
    (`_weighted_evals`), then the same transforms: u, v, h and the
    witness's tail bit for bit, on matrices with a random one-slot ELL
    and `POSEIDON_WIDE_SHAPES`' wide rows (scaled to n rows)."""
    from zksnark_tpu_torch.field.limb import FR_CTX
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import ntt as nttmod
    from zksnark_tpu_torch.ops.montmul import from_mont

    domain = nttmod.get_domain(n.bit_length() - 1, dev)
    scale = n / WIDE_N
    mats = []
    for widths in POSEIDON_WIDE_SHAPES.values():
        part = {k: max(1, int(c * scale)) for k, c in widths.items()}
        idx = torch.from_numpy(gen.integers(0, n, (n, 1))).to(dev)
        val = np_limbs(gen, n).reshape(n, 1, 8).to(dev)
        csr = wide_csr(gen, dev, part, n, n)
        idx[csr[3]] = 0                      # a wide row's ELL slots: padding
        val[csr[3]] = 0
        mats.append(prover.EllMatrix(idx, val, prover.WideRows(*csr)))
    wm = np_limbs(gen, n).to(dev)
    got = prover._witness_quotient(domain, 1, mats, wm)
    evals = [prover._weighted_evals(m, wm) for m in mats]
    u_c, v_c, w_c = (nttmod.intt(domain, e) for e in evals)
    h_c = nttmod.divide_by_vanishing(domain, u_c, v_c, w_c)
    want = (from_mont(FR_CTX, u_c), from_mont(FR_CTX, v_c),
            from_mont(FR_CTX, h_c), from_mont(FR_CTX, wm[2:]))
    return all(torch.equal(a, b) for a, b in zip(got, want))


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
        wide_phase(dev, SEED, results)
        bad = [k for k, r in results.items() if r["path_shape_err"] != 0
               or not (r["bit_exact"] and r["host_edge_ok"])]
        if bad:
            raise SystemExit(f"kernels disagree at the path's shapes: {bad}")
    reference_phase(dev)
    path = path_phase(dev, log_n, n_proves)
    if args.profile:
        profile_phase(*path["state"], args.profile)
    # free the square chain's circuit and CRS: the keccak path's peak
    # memory is read without them; its 2^20 G1 points wait on the host
    # for the bounded MSM
    xi_g1_host = [a.cpu() for a in path["state"][1].xi_g1]
    del path["state"]
    torch.cuda.empty_cache()
    keccak = keccak_phase(dev, 4, 2)
    cli = cli_phase()
    host = host_phase(dev)
    field = field_phase(dev, SEED)
    pmul = poly_mul_phase(dev, SEED)
    from zksnark_tpu_torch.curve.jacobian import JPoint

    bits = msm_bits_phase(dev, JPoint(*(a.to(dev) for a in xi_g1_host)),
                          SEED)
    del xi_g1_host
    torch.cuda.empty_cache()
    bench = bench_phase()
    mesh = mesh_phase(dev, [p["proof"] for p in path["proves"]])
    extra = {"host": host, "field": field, "poly_mul": pmul,
             "msm_bits": bits, "bench": bench, "mesh": mesh}

    kernels = []
    for name, r in results.items():
        op = OP_OF.get(name, name.rsplit("_", 1)[0])
        # each entry's main path: the mesh path for the batched NTT
        main_path = mesh if name in MESH_ONLY else path
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[op],
            "replaces": TPU_KERNELS[op],
            "launches": main_path["launches"][name],
            "max_abs_err": max(r["max_abs_err"], r["path_shape_err"]),
            "path_shape_err": r["path_shape_err"],
            "checked_shapes": r["checked_shapes"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"],
            "launches_per_prove": (
                mesh["runs"][0]["launches_per_prove"][0] if name in MESH_ONLY
                else path["proves"][-1]["launches"])[name],
            "launches_by_path": {
                "square_chain": path["launches"][name],
                "keccak": keccak["launches"][name],
                "cli": cli["launches"][name],
                **{k: v["launches"][name] for k, v in extra.items()}},
            "launches_per_keccak_prove":
                keccak["proves"][-1]["launches"][name],
            **({"c_msm": r["c_msm"]} if "c_msm" in r else {}),
            **({"chain_ms": r["chain_ms"]} if "chain_ms" in r else {}),
            **({"per_shape": r["per_shape"]} if "per_shape" in r else {}),
        })
    log(f"[path] n=2^{log_n}: setup {path['setup_s']:.2f} s (phases "
        f"{ {k: round(v, 4) for k, v in path['setup_phases_s'].items()} } "
        f"s), prove ms {[round(p['ms'], 1) for p in path['proves']]}")
    ks = keccak["summary"]
    log(f"[keccak] n=2^{ks['n'].bit_length() - 1}: setup "
        f"{ks['setup_s']:.2f} s, prove ms "
        f"{[round(t, 1) for t in ks['prove_ms']]}")
    log(f"[field] mont_inv ms per 2^16 + 3 inverses: "
        f"{ {k: round(v['ms'], 3) for k, v in field['mont_inv'].items()} }; "
        f"[poly_mul] 2^20 {pmul['ms']:.3f} ms; [msm_bits] 2^20 "
        f"{bits['ms']:.3f} ms (W = 4) vs {bits['full_ms']:.3f} ms (W = 16); "
        f"[bench] {json.dumps(bench['headline'])}")
    for run in mesh["runs"]:
        log(f"[mesh] {run['backend']} d={run['world']} n=2^{run['log_n']}: "
            f"setup s {[round(t, 2) for t in run['setup_s']]}, prove ms "
            f"{[[round(t, 1) for t in r] for r in run['prove_ms']]}, peak "
            f"GiB {[round(g, 2) for g in run['peak_gib']]}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
