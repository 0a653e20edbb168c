// K3 and K4 as the MSM's tail runs them, on BN254 G1 (over Fq) and G2
// (over Fq2):
//
//   K3  add_gather  out[i] = P[pi[i]] + Q[qi[i]]: the complete Jacobian add
//                 of two rows gathered from two point tables, an index < 0
//                 standing for the canonical infinity (one, one, 0).  The
//                 MSM's tail (zksnark_tpu_torch/ops/msm.py) runs three
//                 uses of it where the JAX package (zksnark_tpu/ops/msm.py)
//                 runs a materialized gather, broadcast or concatenation
//                 and then a launch of the Pallas _add_kernel
//                 (ops/curve_pallas.py:281, _add_core :219):
//                 - the bucket ends with their forward fill (:353-379:
//                   the carry gather, the ends add, the take by the last
//                   valid bucket and the select of infinity before the
//                   first one), in one launch whose output is laid out
//                   (buckets, windows) for the tree sum;
//                 - _prefix_scan's chunk-carry fix-up (:159-161), P the
//                   chunk's carry row, without broadcasting it;
//                 - the Hillis-Steele rounds of _hs_scan (:100-112), P the
//                   row `shift` positions back, infinity before the start.
//   K3  block_scan  running sums of point columns along axis 0, the chunk
//                 carries' prefix scan (_prefix_scan :145) and the tree sum
//                 (tree_sum :176) that the JAX package runs as chunked
//                 scans of the Pallas _add_kernel: a block of T threads
//                 owns T s consecutive positions of one column; each thread
//                 walks its s positions in registers, the block scans its T
//                 thread totals in shared memory (log2 T rounds of one add:
//                 Kogge-Stone when collecting, a pairwise tree when only
//                 the total is asked for), and, when collecting, each thread
//                 walks its positions again from its exclusive prefix.  One
//                 total a block; the caller scans the block totals in the
//                 same kernel, a far smaller level, and adds each block's
//                 carry with one add_gather.
//   K4  abel      the Abel step of one MSM's windows (:384-387):
//                 out = 2^k (C + T) - R, i.e. add_core(C, T), k doublings
//                 and add_core with the negated R (jacobian.neg: X and Z
//                 kept, Y -> 0 - Y), one thread per window in registers,
//                 where the JAX package runs an add, a fori_loop of the
//                 Pallas _double_kernel (:301) and another add.
//
// add_gather and abel run the cores of point_core.cuh on the same operands
// in the same order as the JAX package, so raw Jacobian coordinates are bit
// for bit those of the TPU kernels and of the plain versions in
// zksnark_tpu_torch/ops/curve_kernels.py.  block_scan associates its adds
// otherwise (a block's tree, not one chain), so its sums are other
// Jacobian representatives of the same points; its plain version
// (`block_scan_plain`) runs the same adds in the same association, bit for
// bit.  A lane whose two indices are
// both < 0 stages infinity on both sides, and add_core returns its Q
// before any arithmetic: the canonical infinity, as jacobian.select gives.
//
// Bound on the H100: at 2^18-2^20 outputs integer throughput, as for the
// elementwise add (~20 Fq products a G1 add); the operands are random
// rows of tables that fit in the 50 MB L2 in G1 (the bucket ends' carry
// table is 2^18 x 96 B).  Each thread walks a few outputs (grid-stride)
// and stages the next output's two gathered points in shared memory by
// cp.async, double buffered, while the current add computes, as the scan
// kernels of point_scan.cu do; its indices are read coalesced (neighbour
// threads own neighbour outputs).  add_core's P = Q branch re-reads P
// from the staged copy of row pi[i].  At 16-64 outputs (the Hillis-
// Steele rounds, Abel) the bound is one thread's chain of dependent
// products: one add, or 2 adds and k doublings for Abel.
//
// block_scan: a chain of s adds a thread, log2 T rounds and, collecting,
// s - 1 adds more.  The caller picks T and s (`curve_kernels.
// block_scan_shape`) so that a large level holds ~2^15 threads: there the
// integer units, not one thread's chain of dependent products, bound it,
// where the chunked scan it replaces walked 64 adds on 16 to 16,384
// lanes.  Each thread stages its next point by cp.async, double
// buffered, as the scan kernels do; the block's scan reuses the staging
// buffers.
//
// Layout: each coordinate of a table is an (rows, 8) (G1) or (rows, 2, 8)
// (G2) array of u32 limbs, contiguous and 16-byte aligned; pi and qi are
// (n,) int32, every index < 0 or below its table's rows (unchecked); the
// output is (n, ...) contiguous in the order of the indices and must not
// alias a table.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "point_core.cuh"

namespace {

using bn254::Fe;
using bn254::Fe2;
using bn254::Pt;
using bn254::cp_async16;
using bn254::cp_async_commit;
using bn254::cp_async_wait;

// Threads a block: 64 for G1, 32 for G2, so that the staging buffers
// (2 buffers x 2 points x 3 coordinates a thread) take 24 KB either way.
template <class E>
constexpr int kGatherThreads = sizeof(E) == sizeof(Fe) ? 64 : 32;
constexpr int kGatherPerThread = 4;  // outputs a thread walks at large n
constexpr int kGatherMinBlocks = 264;  // two per SM before walking
constexpr int kAbelThreads = 32;

// Threads a block of the block scan, at most: 128 for G1, 64 for G2.  A
// block's shared memory is three points a thread (dynamic, so a smaller
// block takes less): its staging buffers (2 buffers x 3 coordinates),
// which the block's scan reuses for its T points, and the accumulator
// saved for the add's doubling; 36 KB at most either way.
template <class E>
constexpr int kBlockScanThreads = sizeof(E) == sizeof(Fe) ? 128 : 64;

template <class E>
__device__ __forceinline__ E& staged(uint4* slot) {
  return reinterpret_cast<E*>(slot)[threadIdx.x];
}

template <class E>
__global__ void __launch_bounds__(kGatherThreads<E>)
    add_gather_kernel(const uint32_t* __restrict__ px,
                      const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz,
                      const int* __restrict__ pi,
                      const uint32_t* __restrict__ qx,
                      const uint32_t* __restrict__ qy,
                      const uint32_t* __restrict__ qz,
                      const int* __restrict__ qi, uint32_t* ox, uint32_t* oy,
                      uint32_t* oz, long long n) {
  constexpr int T = kGatherThreads<E>;
  constexpr int W = sizeof(E) / 4;  // u32 words per coordinate
  constexpr int V = W / 4;          // 16-byte pieces per coordinate
  // stage[buf][0..2]: P's X, Y, Z; stage[buf][3..5]: Q's
  __shared__ uint4 stage[2][6][T * V];
  const long long stride = (long long)gridDim.x * T;
  long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= n) return;

  // Stage output `at`'s two operands in buffer buf: each by cp.async from
  // its row, or infinity for an index < 0.  Each thread reads only its
  // own slots, so no barrier is needed: cp.async.wait_group makes a
  // thread's own copies visible to it.
  auto fetch = [&](int buf, long long at) {
    const int rows[2] = {pi[at], qi[at]};
#pragma unroll
    for (int s = 0; s < 2; s++) {
      const uint32_t* base[3] = {s ? qx : px, s ? qy : py, s ? qz : pz};
      if (rows[s] >= 0) {
        const size_t off = (size_t)rows[s] * W;
#pragma unroll
        for (int k = 0; k < 3 * V; k++)
          cp_async16(&stage[buf][3 * s + k / V][threadIdx.x * V + k % V],
                     base[k / V] + off + 4 * (k % V));
      } else {
        E one, zero;
        bn254::fone(one);
        bn254::fzero_set(zero);
        staged<E>(stage[buf][3 * s]) = one;
        staged<E>(stage[buf][3 * s + 1]) = one;
        staged<E>(stage[buf][3 * s + 2]) = zero;
      }
    }
    cp_async_commit();
  };

  fetch(0, i);
  for (int it = 0;; it++) {
    const long long next = i + stride;
    const int buf = it & 1;
    if (next < n) {
      fetch(buf ^ 1, next);  // its slots were last read at it - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    uint4(*const st)[T * V] = stage[buf];
    const Pt<E> r = bn254::add_core(
        staged<E>(st[0]), staged<E>(st[1]), staged<E>(st[2]),
        staged<E>(st[3]), staged<E>(st[4]), staged<E>(st[5]), [&] {
          return bn254::pt_make(
              bn254::elem_again<E>(
                  reinterpret_cast<const uint32_t*>(&staged<E>(st[0]))),
              bn254::elem_again<E>(
                  reinterpret_cast<const uint32_t*>(&staged<E>(st[1]))),
              bn254::elem_again<E>(
                  reinterpret_cast<const uint32_t*>(&staged<E>(st[2]))));
        });
    bn254::store_pt(ox, oy, oz, i, r);
    if (next >= n) break;
    i = next;
  }
}

template <class E>
__global__ void __launch_bounds__(kAbelThreads)
    abel_kernel(const uint32_t* cx, const uint32_t* cy, const uint32_t* cz,
                const uint32_t* tx, const uint32_t* ty, const uint32_t* tz,
                const uint32_t* rx, const uint32_t* ry, const uint32_t* rz,
                uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                int k) {
  __shared__ Pt<E> saved[kAbelThreads];  // 2^k E_top, for P = Q
  const long long i = (long long)blockIdx.x * kAbelThreads + threadIdx.x;
  if (i >= n) return;
  const Pt<E> c = bn254::load_pt<E>(cx, cy, cz, i);
  const Pt<E> t = bn254::load_pt<E>(tx, ty, tz, i);
  Pt<E> e = bn254::add_core(c.x, c.y, c.z, t.x, t.y, t.z, [&] {
    return bn254::load_pt_again<E>(cx, cy, cz, i);
  });
  for (int j = 0; j < k; j++) e = bn254::double_core(e.x, e.y, e.z);
  Pt<E> r = bn254::load_pt<E>(rx, ry, rz, i);
  E zero;
  bn254::fzero_set(zero);
  r.y = bn254::fsub(zero, r.y);  // jacobian.neg: 0 - Y, 0 stays 0
  saved[threadIdx.x] = e;
  const Pt<E> out = bn254::add_core(e.x, e.y, e.z, r.x, r.y, r.z, [&] {
    return bn254::pt_again(saved[threadIdx.x]);
  });
  bn254::store_pt(ox, oy, oz, i, out);
}

// Block (k, col) = blockIdx.x (k * r + col) owns positions [k T s, k T s +
// T s) of column col, position i being point i * r + col of the (n, r)
// input; thread t owns [k T s + t s, k T s + t s + s), and positions at or
// past n are skipped (no add, no write).  totals (nblk, r) gets each
// block's sum; when collecting, w (the input's layout) every inclusive
// prefix within the block.
template <class E>
__global__ void __launch_bounds__(kBlockScanThreads<E>)
    block_scan_kernel(const uint32_t* __restrict__ px,
                      const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, uint32_t* tx,
                      uint32_t* ty, uint32_t* tz, uint32_t* wx, uint32_t* wy,
                      uint32_t* wz, long long n, long long r, int s,
                      int collect) {
  constexpr int W = sizeof(E) / 4;  // u32 words per coordinate
  constexpr int V = W / 4;          // 16-byte pieces per coordinate
  const int t = threadIdx.x, nt = blockDim.x;
  // stage(buf, k): coordinate k of every thread's staged point, nt * V
  // pieces; then the saved accumulators
  extern __shared__ uint4 smem[];
  auto stage = [&](int buf, int k) { return smem + (buf * 3 + k) * nt * V; };
  Pt<E>* const saved = reinterpret_cast<Pt<E>*>(smem + 6 * nt * V);
  // the block's scan: one point a thread, in the staging buffers
  Pt<E>* const sh = reinterpret_cast<Pt<E>*>(smem);
  const long long col = blockIdx.x % r;
  const long long first = ((long long)(blockIdx.x / r) * nt + t) * s;
  const long long left = n - first;
  const int live = left <= 0 ? 0 : left < s ? (int)left : s;
  auto at = [&](int j) { return (first + j) * r + col; };

  // Each thread stages its own point of step j in its slots of buffer
  // buf and reads nothing else there (cp.async.wait_group makes a
  // thread's own copies visible to it).
  auto fetch = [&](int buf, int j) {
    const size_t off = (size_t)at(j) * W;
#pragma unroll
    for (int k = 0; k < 3 * V; k++) {
      const uint32_t* base = k / V == 0 ? px : k / V == 1 ? py : pz;
      cp_async16(stage(buf, k / V) + t * V + k % V, base + off + 4 * (k % V));
    }
    cp_async_commit();
  };
  // acc += the thread's positions 0 .. len - 1 in order, each sum written
  // to w when `write`
  Pt<E> acc = bn254::pt_infinity<E>();
  auto walk = [&](int len, bool write) {
    if (len > 0) fetch(0, 0);
    for (int j = 0; j < len; j++) {
      if (j + 1 < len) {
        fetch((j + 1) & 1, j + 1);  // its slots were last read at j - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      saved[t] = acc;
      acc = bn254::add_core(acc.x, acc.y, acc.z, staged<E>(stage(j & 1, 0)),
                            staged<E>(stage(j & 1, 1)),
                            staged<E>(stage(j & 1, 2)),
                            [&] { return bn254::pt_again(saved[t]); });
      if (write) bn254::store_pt(wx, wy, wz, at(j), acc);
    }
  };

  walk(live, false);
  // the thread totals' scan: round d adds the point d threads back
  // (collecting: every thread's inclusive prefix) or, in a pairwise tree,
  // the point d threads on (only thread 0's total is kept)
  for (int d = 1; d < nt; d <<= 1) {
    __syncthreads();  // the staging or the previous round's reads are done
    sh[t] = acc;
    __syncthreads();
    if (collect) {
      if (t >= d)
        acc = bn254::add_core(sh[t - d].x, sh[t - d].y, sh[t - d].z, acc.x,
                              acc.y, acc.z,
                              [&] { return bn254::pt_again(sh[t - d]); });
    } else if ((t & (2 * d - 1)) == 0 && t + d < nt) {
      acc = bn254::add_core(acc.x, acc.y, acc.z, sh[t + d].x, sh[t + d].y,
                            sh[t + d].z,
                            [&] { return bn254::pt_again(sh[t]); });
    }
  }
  if (t == (collect ? nt - 1 : 0)) bn254::store_pt(tx, ty, tz, blockIdx.x, acc);
  if (!collect) return;

  // the last live position's prefix is the thread's inclusive one; the
  // others are walked again from the exclusive one, thread t - 1's
  if (live > 0) bn254::store_pt(wx, wy, wz, at(live - 1), acc);
  __syncthreads();
  sh[t] = acc;
  __syncthreads();
  acc = t > 0 ? sh[t - 1] : bn254::pt_infinity<E>();
  __syncthreads();  // every exclusive prefix is read before the staging
  walk(live - 1, true);
}

const uint32_t* in(const void* p) { return static_cast<const uint32_t*>(p); }
uint32_t* out(void* p) { return static_cast<uint32_t*>(p); }

template <class E>
int launch_gather(const void* px, const void* py, const void* pz,
                  const void* pi, const void* qx, const void* qy,
                  const void* qz, const void* qi, void* ox, void* oy,
                  void* oz, long long n, cudaStream_t s) {
  constexpr int T = kGatherThreads<E>;
  const long long one_each = (n + T - 1) / T;
  const long long per_block = (long long)T * kGatherPerThread;
  const long long walked = (n + per_block - 1) / per_block;
  // one output a thread up to kGatherMinBlocks blocks, then
  // kGatherPerThread outputs a thread (at least kGatherMinBlocks blocks)
  long long blocks = one_each;
  if (blocks > kGatherMinBlocks)
    blocks = walked > kGatherMinBlocks ? walked : kGatherMinBlocks;
  add_gather_kernel<E><<<(unsigned)blocks, T, 0, s>>>(
      in(px), in(py), in(pz), static_cast<const int*>(pi), in(qx), in(qy),
      in(qz), static_cast<const int*>(qi), out(ox), out(oy), out(oz), n);
  return (int)cudaGetLastError();
}

}  // namespace

// out[i] = P[pi[i]] + Q[qi[i]] for i < n (an index < 0: infinity)
extern "C" int zk_point_add_gather(int g2, const void* px, const void* py,
                                   const void* pz, const void* pi,
                                   const void* qx, const void* qy,
                                   const void* qz, const void* qi, void* ox,
                                   void* oy, void* oz, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (g2)
    return launch_gather<Fe2>(px, py, pz, pi, qx, qy, qz, qi, ox, oy, oz, n,
                              s);
  return launch_gather<Fe>(px, py, pz, pi, qx, qy, qz, qi, ox, oy, oz, n, s);
}

// The block scan of the (n, r) point columns p along axis 0, `threads`
// (a power of two, at most 128 for G1 and 64 for G2) x `steps` positions a
// block: totals (ceil(n / (threads steps)), r) always, every inclusive
// prefix within a block into w (p's layout) when collect is set.
extern "C" int zk_point_block_scan(int g2, const void* px, const void* py,
                                   const void* pz, void* tx, void* ty,
                                   void* tz, void* wx, void* wy, void* wz,
                                   long long n, long long r, int threads,
                                   int steps, int collect, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  const int most = g2 ? kBlockScanThreads<Fe2> : kBlockScanThreads<Fe>;
  if (threads < 1 || threads > most || (threads & (threads - 1)) ||
      steps < 1 || n * r >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long span = (long long)threads * steps;
  const long long blocks = (n + span - 1) / span * r;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = 3 * (size_t)threads * (g2 ? sizeof(Pt<Fe2>)
                                                 : sizeof(Pt<Fe>));
  if (g2)
    block_scan_kernel<Fe2><<<(unsigned)blocks, threads, smem, s>>>(
        in(px), in(py), in(pz), out(tx), out(ty), out(tz), out(wx), out(wy),
        out(wz), n, r, steps, collect);
  else
    block_scan_kernel<Fe><<<(unsigned)blocks, threads, smem, s>>>(
        in(px), in(py), in(pz), out(tx), out(ty), out(tz), out(wx), out(wy),
        out(wz), n, r, steps, collect);
  return (int)cudaGetLastError();
}

// out[i] = 2^k (C[i] + T[i]) - R[i] for i < n
extern "C" int zk_point_abel(int g2, const void* cx, const void* cy,
                             const void* cz, const void* tx, const void* ty,
                             const void* tz, const void* rx, const void* ry,
                             const void* rz, void* ox, void* oy, void* oz,
                             long long n, int k, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kAbelThreads - 1) / kAbelThreads);
  if (g2)
    abel_kernel<Fe2><<<blocks, kAbelThreads, 0, s>>>(
        in(cx), in(cy), in(cz), in(tx), in(ty), in(tz), in(rx), in(ry),
        in(rz), out(ox), out(oy), out(oz), n, k);
  else
    abel_kernel<Fe><<<blocks, kAbelThreads, 0, s>>>(
        in(cx), in(cy), in(cz), in(tx), in(ty), in(tz), in(rx), in(ry),
        in(rz), out(ox), out(oy), out(oz), n, k);
  return (int)cudaGetLastError();
}
