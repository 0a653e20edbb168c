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
//   K4  abel      the Abel step of one MSM's windows (:384-387):
//                 out = 2^k (C + T) - R, i.e. add_core(C, T), k doublings
//                 and add_core with the negated R (jacobian.neg: X and Z
//                 kept, Y -> 0 - Y), one thread per window in registers,
//                 where the JAX package runs an add, a fori_loop of the
//                 Pallas _double_kernel (:301) and another add.
//
// Both run the cores of point_core.cuh on the same operands in the same
// order as the JAX package, so raw Jacobian coordinates are bit for bit
// those of the TPU kernels and of the plain versions in
// zksnark_tpu_torch/ops/curve_kernels.py.  A lane whose two indices are
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
