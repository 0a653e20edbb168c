// K3 and K4 as the MSM runs them: sequential chains of point operations,
// each in one launch, on BN254 G1 (over Fq) and G2 (over Fq2).
//
//   K3  add_scan  inclusive running sums of point lanes: one thread owns
//                 one lane, keeps its accumulator in registers (and a copy
//                 in shared memory for the add's rare doubling branch) and
//                 walks the c sequential positions inside the kernel.  Replaces
//                 the chunked scans of zksnark_tpu/ops/msm.py
//                 (_scan_chunks :126, under _prefix_scan :145 and tree_sum
//                 :176), a lax.scan whose every step is a launch of the
//                 Pallas _add_kernel (ops/curve_pallas.py:281).
//   K4  horner    the windows' Horner tail, acc = 2^c acc + W_w, MSB window
//                 first, in one thread per MSM: replaces horner_body
//                 (msm.py:449-456), W x (c launches of _double_kernel
//                 (curve_pallas.py:301) + one of _add_kernel).
//
// Both run the same additions and doublings in the same order as the
// loops they replace, through the cores of point_core.cuh, so the raw
// Jacobian coordinates are those of the JAX package and of the plain
// versions in zksnark_tpu_torch/ops/curve_kernels.py.
//
// add_scan layout: the points are a (b, c, r) grid (chunk, position,
// lane within the chunk) in place, so lane l = (l / r, l % r) reads
// position j at ((l / r) * c + j) * r + l % r.  A (1, c, L) grid is the
// step-major layout (c, L).  `within` (when collecting) has the grid's
// layout, `totals` is (b, r).  Neighbouring threads own neighbouring
// lanes, and each stages its lane's point of the next step in shared
// memory with cp.async, 16 bytes a copy, double buffered: step j + 1's
// copy is in flight while step j adds.  The combine is a template
// parameter (add_core, or madd_core for the bucket scan's affine points).
//
// Bound on the H100: at many lanes (2^14 lanes x 64 steps) integer
// throughput, as for the elementwise add; at few lanes (64 lanes, 16
// window totals, one Horner thread) the latency of one thread's chain of
// dependent Montgomery products: c steps of one add each, or W (c + 1)
// point operations for Horner.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "point_core.cuh"

namespace {

using bn254::Fe;
using bn254::Fe2;
using bn254::Pt;

constexpr int kScanThreads = 64;
constexpr int kHornerThreads = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (b, c, r) grid: the point index of lane l at position 0; position j
// is j * r further.  Grids hold fewer than 2^31 points (launch_scan
// refuses larger ones).
__device__ __forceinline__ unsigned grid_base(long long l, int c,
                                              long long r) {
  return (unsigned)((l / r) * c * r + l % r);
}

template <class E, bool MIXED>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const uint32_t* __restrict__ px,
                const uint32_t* __restrict__ py,
                const uint32_t* __restrict__ pz, uint32_t* tx, uint32_t* ty,
                uint32_t* tz, uint32_t* wx, uint32_t* wy, uint32_t* wz,
                long long lanes, int c, long long r, int collect) {
  constexpr int W = sizeof(E) / 4;  // u32 words per coordinate
  constexpr int V = W / 4;          // 16-byte pieces per coordinate
  __shared__ uint4 stage[2][3][kScanThreads * V];
  __shared__ Pt<E> saved[kScanThreads];  // the accumulator, for P = Q
  const long long l = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (l >= lanes) return;
  const unsigned step = (unsigned)r;
  const unsigned own = grid_base(l, c, r);

  // Each thread stages its own lane's point of step j in its slots of
  // stage[buf] and reads nothing else there, so no barrier is needed:
  // cp.async.wait_group makes a thread's own copies visible to it.
  auto fetch = [&](int buf, int j) {
    const size_t at = (size_t)(own + j * step) * W;
#pragma unroll
    for (int k = 0; k < 3 * V; k++) {
      const uint32_t* base = k / V == 0 ? px : k / V == 1 ? py : pz;
      cp_async16(&stage[buf][k / V][threadIdx.x * V + k % V],
                 base + at + 4 * (k % V));
    }
    cp_async_commit();
  };

  Pt<E> acc = bn254::pt_infinity<E>();
  if (c > 0) fetch(0, 0);
  for (int j = 0; j < c; j++) {
    if (j + 1 < c) {
      fetch((j + 1) & 1, j + 1);  // its slots were last read at step j - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const E& qx = reinterpret_cast<const E*>(stage[j & 1][0])[threadIdx.x];
    const E& qy = reinterpret_cast<const E*>(stage[j & 1][1])[threadIdx.x];
    const E& qz = reinterpret_cast<const E*>(stage[j & 1][2])[threadIdx.x];
    if constexpr (MIXED) {
      acc = bn254::madd_core(acc.x, acc.y, acc.z, qx, qy, qz);
    } else {
      saved[threadIdx.x] = acc;
      acc = bn254::add_core(acc.x, acc.y, acc.z, qx, qy, qz, [&] {
        return bn254::pt_again(saved[threadIdx.x]);
      });
    }
    if (collect) bn254::store_pt(wx, wy, wz, own + j * step, acc);
  }
  bn254::store_pt(tx, ty, tz, l, acc);
}

// sums: (nwin, n) window sums; out: (n,)
template <class E>
__global__ void __launch_bounds__(kHornerThreads)
    horner_kernel(const uint32_t* sx, const uint32_t* sy, const uint32_t* sz,
                  uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                  int nwin, int c) {
  __shared__ Pt<E> saved[kHornerThreads];  // the accumulator, for P = Q
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E> acc = bn254::pt_infinity<E>();
  for (int w = nwin - 1; w >= 0; w--) {
    for (int t = 0; t < c; t++) acc = bn254::double_core(acc.x, acc.y, acc.z);
    Pt<E> s = bn254::load_pt<E>(sx, sy, sz, w * n + i);
    saved[threadIdx.x] = acc;
    acc = bn254::add_core(acc.x, acc.y, acc.z, s.x, s.y, s.z, [&] {
      return bn254::pt_again(saved[threadIdx.x]);
    });
  }
  bn254::store_pt(ox, oy, oz, i, acc);
}

const uint32_t* in(const void* p) { return static_cast<const uint32_t*>(p); }
uint32_t* out(void* p) { return static_cast<uint32_t*>(p); }

template <bool MIXED>
int launch_scan(int g2, const void* px, const void* py, const void* pz,
                void* tx, void* ty, void* tz, void* wx, void* wy, void* wz,
                long long b, int c, long long r, int collect, void* stream) {
  long long lanes = b * r;
  if (lanes <= 0) return 0;
  if (lanes * c >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks = (unsigned)((lanes + kScanThreads - 1) / kScanThreads);
  if (g2)
    scan_kernel<Fe2, MIXED><<<blocks, kScanThreads, 0, s>>>(
        in(px), in(py), in(pz), out(tx), out(ty), out(tz), out(wx), out(wy),
        out(wz), lanes, c, r, collect);
  else
    scan_kernel<Fe, MIXED><<<blocks, kScanThreads, 0, s>>>(
        in(px), in(py), in(pz), out(tx), out(ty), out(tz), out(wx), out(wy),
        out(wz), lanes, c, r, collect);
  return (int)cudaGetLastError();
}

}  // namespace

// Running sums over the (b, c, r) grid p: totals (b, r) always, every
// inclusive prefix into w (the grid's layout) when collect is set.
extern "C" int zk_point_add_scan(int g2, const void* px, const void* py,
                                 const void* pz, void* tx, void* ty, void* tz,
                                 void* wx, void* wy, void* wz, long long b,
                                 int c, long long r, int collect,
                                 void* stream) {
  return launch_scan<false>(g2, px, py, pz, tx, ty, tz, wx, wy, wz, b, c, r,
                            collect, stream);
}

// Horner over nwin windows of n independent MSMs: out = sum_w 2^(c w) W_w,
// as acc = 2^c acc + W_w from the top window down.
extern "C" int zk_point_horner(int g2, const void* sx, const void* sy,
                               const void* sz, void* ox, void* oy, void* oz,
                               long long n, int nwin, int c, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks = (unsigned)((n + kHornerThreads - 1) / kHornerThreads);
  if (g2)
    horner_kernel<Fe2><<<blocks, kHornerThreads, 0, s>>>(
        in(sx), in(sy), in(sz), out(ox), out(oy), out(oz), n, nwin, c);
  else
    horner_kernel<Fe><<<blocks, kHornerThreads, 0, s>>>(
        in(sx), in(sy), in(sz), out(ox), out(oy), out(oz), n, nwin, c);
  return (int)cudaGetLastError();
}
