// K2-K4: complete Jacobian point operations on BN254 G1 (over Fq) and G2
// (over Fq2), one thread per point:
//
//   K2  madd   P + Q with Q affine or infinity (Z in {0, one}),
//              madd-2007-bl; replaces zksnark_tpu/ops/curve_pallas.py
//              _madd_kernel / _madd_core (:169-216, :291-298)
//   K3  add    P + Q, add-2007-bl; replaces _add_kernel / _add_core
//              (:219-265, :281-288)
//   K4  double 2P, dbl-2009-l for a = 0; replaces _double_kernel /
//              _double_core (:138-151, :301-307)
//
// All three were launched by _point_call (:337-356, pallas_call at :346).
// The formulas, the order of the field operations and the edge cases are
// exactly those of the Pallas cores, so raw Jacobian coordinates are bit
// for bit those of the TPU kernels and of the plain PyTorch versions
// (zksnark_tpu_torch/ops/curve_kernels.py):
//   P = Q        madd doubles the affine Q (_double_affine_core),
//                add falls back to dbl-2009-l on P;
//   P = -Q       gives infinity (one, one, 0);
//   Q = inf      gives P;  P = inf gives Q (applied last, in that order).
// The masks are the TPU kernels' selects; the one difference is that the
// doubling for P = Q is computed only in a thread whose P and Q are both
// finite (a branch instead of a select): everywhere else the infinity
// selects override it, so no result changes.
//
// Bound on the H100: integer throughput.  A G1 madd is ~16 Fq
// multiplications (~270 IMAD-class instructions each, ~4k per point) for
// 288 B of traffic (six 32 B inputs, three 32 B outputs); a G2 madd is
// ~3x the multiplications for 2x the bytes.  One thread per point keeps
// the whole formula in registers (G2 spills some); fusing the MSM's scan
// steps into one kernel is later work.
//
// Layout: each coordinate is an (n, 8) (G1) or (n, 2, 8) (G2) array of
// u32 limbs, contiguous and 16-byte aligned.  Outputs may alias inputs
// (each thread reads its own point before it writes it).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

using bn254::Fe;
using bn254::Fe2;
using bn254::fadd;
using bn254::fdbl;
using bn254::fmul;
using bn254::fsel;
using bn254::fsqr;
using bn254::fsub;
using bn254::fzero;

template <class E>
struct Pt {
  E x, y, z;
};

// dbl-2009-l (_double_core)
template <class E>
__device__ __forceinline__ Pt<E> double_core(const E& x, const E& y,
                                             const E& z) {
  E a = fsqr(x);
  E b = fsqr(y);
  E c = fsqr(b);
  E d = fsub(fsqr(fadd(x, b)), fadd(a, c));
  d = fdbl(d);
  E e = fadd(fdbl(a), a);
  E f = fsqr(e);
  Pt<E> r;
  r.x = fsub(f, fdbl(d));
  E c8 = fdbl(fdbl(fdbl(c)));
  r.y = fsub(fmul(e, fsub(d, r.x)), c8);
  r.z = fdbl(fmul(y, z));
  return r;
}

// dbl-2009-l at Z = 1 (_double_affine_core)
template <class E>
__device__ __forceinline__ Pt<E> double_affine_core(const E& x, const E& y) {
  E a = fsqr(x);
  E b = fsqr(y);
  E c = fsqr(b);
  E d = fdbl(fsub(fsqr(fadd(x, b)), fadd(a, c)));
  E e = fadd(fdbl(a), a);
  E f = fsqr(e);
  Pt<E> r;
  r.x = fsub(f, fdbl(d));
  E c8 = fdbl(fdbl(fdbl(c)));
  r.y = fsub(fmul(e, fsub(d, r.x)), c8);
  r.z = fdbl(y);
  return r;
}

// the edge-case masks shared by madd and add, in the TPU kernels' order
template <class E>
__device__ __forceinline__ void finish(Pt<E>& r, bool h_zero, bool r_zero,
                                       const E& px, const E& py, const E& pz,
                                       const E& qx, const E& qy,
                                       const E& qz) {
  bool p_inf = fzero(pz);
  bool q_inf = fzero(qz);
  bool cancel = h_zero && !r_zero && !p_inf && !q_inf;
  E one, zero;
  bn254::fone(one);
  bn254::fzero_set(zero);
  r.x = fsel(cancel, one, r.x);
  r.y = fsel(cancel, one, r.y);
  r.z = fsel(cancel, zero, r.z);
  r.x = fsel(q_inf, px, r.x);
  r.y = fsel(q_inf, py, r.y);
  r.z = fsel(q_inf, pz, r.z);
  r.x = fsel(p_inf, qx, r.x);
  r.y = fsel(p_inf, qy, r.y);
  r.z = fsel(p_inf, qz, r.z);
}

// madd-2007-bl (_madd_core); Q.z must be 0 or the Montgomery one
template <class E>
__device__ __forceinline__ Pt<E> madd_core(const E& px, const E& py,
                                           const E& pz, const E& qx,
                                           const E& qy, const E& qz) {
  E z1z1 = fsqr(pz);
  E u2 = fmul(qx, z1z1);
  E s2 = fmul(fmul(qy, pz), z1z1);
  E h = fsub(u2, px);
  E hh = fsqr(h);
  E i = fdbl(fdbl(hh));
  E j = fmul(h, i);
  E rsub = fsub(s2, py);
  E rr = fdbl(rsub);
  E v = fmul(px, i);
  Pt<E> r;
  r.x = fsub(fsub(fsqr(rr), j), fdbl(v));
  r.y = fsub(fmul(rr, fsub(v, r.x)), fdbl(fmul(py, j)));
  r.z = fmul(fdbl(pz), h);
  bool h_zero = fzero(h);
  bool r_zero = fzero(rsub);
  if (h_zero && r_zero && !fzero(pz) && !fzero(qz))
    r = double_affine_core(qx, qy);
  finish(r, h_zero, r_zero, px, py, pz, qx, qy, qz);
  return r;
}

// add-2007-bl (_add_core)
template <class E>
__device__ __forceinline__ Pt<E> add_core(const E& px, const E& py,
                                          const E& pz, const E& qx,
                                          const E& qy, const E& qz) {
  E z1z1 = fsqr(pz);
  E z2z2 = fsqr(qz);
  E u1 = fmul(px, z2z2);
  E u2 = fmul(qx, z1z1);
  E s1 = fmul(fmul(py, qz), z2z2);
  E s2 = fmul(fmul(qy, pz), z1z1);
  E h = fsub(u2, u1);
  E i = fsqr(fdbl(h));
  E j = fmul(h, i);
  E rsub = fsub(s2, s1);
  E rr = fdbl(rsub);
  E v = fmul(u1, i);
  Pt<E> r;
  r.x = fsub(fsub(fsqr(rr), j), fdbl(v));
  r.y = fsub(fmul(rr, fsub(v, r.x)), fdbl(fmul(s1, j)));
  r.z = fmul(fsub(fsqr(fadd(pz, qz)), fadd(z1z1, z2z2)), h);
  bool h_zero = fzero(h);
  bool r_zero = fzero(rsub);
  if (h_zero && r_zero && !fzero(pz) && !fzero(qz))
    r = double_core(px, py, pz);
  finish(r, h_zero, r_zero, px, py, pz, qx, qy, qz);
  return r;
}

template <class E, bool MIXED>
__global__ void __launch_bounds__(128)
    binary_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                  const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
                  uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  E ax = bn254::load_elem<E>(px, i), ay = bn254::load_elem<E>(py, i),
    az = bn254::load_elem<E>(pz, i);
  E bx = bn254::load_elem<E>(qx, i), by = bn254::load_elem<E>(qy, i),
    bz = bn254::load_elem<E>(qz, i);
  Pt<E> r;
  if constexpr (MIXED)
    r = madd_core(ax, ay, az, bx, by, bz);
  else
    r = add_core(ax, ay, az, bx, by, bz);
  bn254::store_elem(ox, i, r.x);
  bn254::store_elem(oy, i, r.y);
  bn254::store_elem(oz, i, r.z);
}

template <class E>
__global__ void __launch_bounds__(128)
    double_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                  uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  E ax = bn254::load_elem<E>(px, i), ay = bn254::load_elem<E>(py, i),
    az = bn254::load_elem<E>(pz, i);
  Pt<E> r = double_core(ax, ay, az);
  bn254::store_elem(ox, i, r.x);
  bn254::store_elem(oy, i, r.y);
  bn254::store_elem(oz, i, r.z);
}

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <bool MIXED>
int launch_binary(int g2, const void* px, const void* py, const void* pz,
                  const void* qx, const void* qy, const void* qz, void* ox,
                  void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto m = [](void* p) { return static_cast<uint32_t*>(p); };
  if (g2)
    binary_kernel<Fe2, MIXED><<<blocks_for(n), kThreads, 0, s>>>(
        c(px), c(py), c(pz), c(qx), c(qy), c(qz), m(ox), m(oy), m(oz), n);
  else
    binary_kernel<Fe, MIXED><<<blocks_for(n), kThreads, 0, s>>>(
        c(px), c(py), c(pz), c(qx), c(qy), c(qz), m(ox), m(oy), m(oz), n);
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

extern "C" int zk_point_double(int g2, const void* px, const void* py,
                               const void* pz, void* ox, void* oy, void* oz,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto m = [](void* p) { return static_cast<uint32_t*>(p); };
  if (g2)
    double_kernel<Fe2><<<blocks_for(n), kThreads, 0, s>>>(
        c(px), c(py), c(pz), m(ox), m(oy), m(oz), n);
  else
    double_kernel<Fe><<<blocks_for(n), kThreads, 0, s>>>(
        c(px), c(py), c(pz), m(ox), m(oy), m(oz), n);
  return (int)cudaGetLastError();
}
