// K2-K4, elementwise: complete Jacobian point operations on BN254 G1 (over
// Fq) and G2 (over Fq2), one thread per point:
//
//   K2  madd      P + Q with Q affine or infinity; replaces
//                 zksnark_tpu/ops/curve_pallas.py _madd_kernel (:291-298)
//   K3  add       P + Q; replaces _add_kernel (:281-288)
//   K4  double    2P; replaces _double_kernel (:301-307)
//   K4  double_n  2^k P: k doublings in registers, one launch where the
//                 JAX package runs `_double_n` (zksnark_tpu/ops/msm.py:211,
//                 a fori_loop of K4); the MSM's Abel step runs its
//                 doublings in point_tail.cu's abel
//
// All of them were launched by _point_call (curve_pallas.py:337-356,
// pallas_call at :346).  The formulas are the cores of point_core.cuh.
// The sequential chains of the MSM (its add scans and its Horner tail) are
// in point_scan.cu.
//
// Bound on the H100: integer throughput at the large shapes.  A G1 madd is
// ~11 Fq multiplications (~270 IMAD-class instructions each, ~3k per
// point) for 288 B of traffic (six 32 B inputs, three 32 B outputs); a G2
// madd is ~3x the multiplications for 2x the bytes.  One thread per point
// keeps the formula in registers: the cores' early returns and the add's
// re-read of P shorten live ranges, and the rolled Montgomery loop
// (bn254_field.cuh) keeps the code within the instruction cache; ptxas
// then fits the G2 add and madd in 168 registers with a spill of 28-32
// bytes, its own choice over a spill-free allocation with fewer blocks
// per SM (PERF.md).  At small shapes (double_n on the 16 window totals)
// the bound is the latency of one thread's chain.
//
// Layout: each coordinate is an (n, 8) (G1) or (n, 2, 8) (G2) array of
// u32 limbs, contiguous and 16-byte aligned.  Outputs may alias inputs
// (each thread reads its own point before it writes it).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "point_core.cuh"

namespace {

using bn254::Fe;
using bn254::Fe2;
using bn254::Pt;

constexpr int kThreads = 128;

template <class E, bool MIXED>
__global__ void __launch_bounds__(kThreads)
    binary_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                  const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
                  uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E> a = bn254::load_pt<E>(px, py, pz, i);
  Pt<E> b = bn254::load_pt<E>(qx, qy, qz, i);
  Pt<E> r;
  if constexpr (MIXED)
    r = bn254::madd_core(a.x, a.y, a.z, b.x, b.y, b.z);
  else
    r = bn254::add_core(a.x, a.y, a.z, b.x, b.y, b.z, [&] {
      return bn254::load_pt_again<E>(px, py, pz, i);
    });
  bn254::store_pt(ox, oy, oz, i, r);
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    double_n_kernel(const uint32_t* px, const uint32_t* py,
                    const uint32_t* pz, uint32_t* ox, uint32_t* oy,
                    uint32_t* oz, long long n, int k) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E> a = bn254::load_pt<E>(px, py, pz, i);
  for (int t = 0; t < k; t++) a = bn254::double_core(a.x, a.y, a.z);
  bn254::store_pt(ox, oy, oz, i, a);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

const uint32_t* in(const void* p) { return static_cast<const uint32_t*>(p); }
uint32_t* out(void* p) { return static_cast<uint32_t*>(p); }

template <bool MIXED>
int launch_binary(int g2, const void* px, const void* py, const void* pz,
                  const void* qx, const void* qy, const void* qz, void* ox,
                  void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (g2)
    binary_kernel<Fe2, MIXED><<<blocks_for(n), kThreads, 0, s>>>(
        in(px), in(py), in(pz), in(qx), in(qy), in(qz), out(ox), out(oy),
        out(oz), n);
  else
    binary_kernel<Fe, MIXED><<<blocks_for(n), kThreads, 0, s>>>(
        in(px), in(py), in(pz), in(qx), in(qy), in(qz), out(ox), out(oy),
        out(oz), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zk_point_madd(int g2, const void* px, const void* py,
                             const void* pz, const void* qx, const void* qy,
                             const void* qz, void* ox, void* oy, void* oz,
                             long long n, void* stream) {
  return launch_binary<true>(g2, px, py, pz, qx, qy, qz, ox, oy, oz, n,
                             stream);
}

extern "C" int zk_point_add(int g2, const void* px, const void* py,
                            const void* pz, const void* qx, const void* qy,
                            const void* qz, void* ox, void* oy, void* oz,
                            long long n, void* stream) {
  return launch_binary<false>(g2, px, py, pz, qx, qy, qz, ox, oy, oz, n,
                              stream);
}

// k doublings of each of the n points (k = 0 copies them)
extern "C" int zk_point_double_n(int g2, const void* px, const void* py,
                                 const void* pz, void* ox, void* oy, void* oz,
                                 long long n, int k, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (g2)
    double_n_kernel<Fe2><<<blocks_for(n), kThreads, 0, s>>>(
        in(px), in(py), in(pz), out(ox), out(oy), out(oz), n, k);
  else
    double_n_kernel<Fe><<<blocks_for(n), kThreads, 0, s>>>(
        in(px), in(py), in(pz), out(ox), out(oy), out(oz), n, k);
  return (int)cudaGetLastError();
}

extern "C" int zk_point_double(int g2, const void* px, const void* py,
                               const void* pz, void* ox, void* oy, void* oz,
                               long long n, void* stream) {
  return zk_point_double_n(g2, px, py, pz, ox, oy, oz, n, 1, stream);
}
