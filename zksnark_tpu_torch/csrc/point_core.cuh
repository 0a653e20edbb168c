// Complete Jacobian point formulas on BN254 G1 (over Fq) and G2 (over
// Fq2), for one thread: the cores that every point kernel
// (point_ops.cu, point_scan.cu) inlines.
//
//   madd_core    P + Q with Q affine or infinity (Z in {0, one}),
//                madd-2007-bl; zksnark_tpu/ops/curve_pallas.py _madd_core
//                (:169-216)
//   add_core     P + Q, add-2007-bl; _add_core (:219-265)
//   double_core  2P, dbl-2009-l for a = 0; _double_core (:138-151)
//
// The formulas and the order of the field operations are exactly those of
// the Pallas cores, so raw Jacobian coordinates are bit for bit those of
// the TPU kernels and of the plain PyTorch versions
// (zksnark_tpu_torch/ops/curve_kernels.py).  The Pallas cores compute the
// formula for every lane and then apply the edge-case selects in this
// order: P = -Q gives infinity (one, one, 0); Q = inf gives P; P = inf
// gives Q; and P = Q takes the doubling (madd doubles the affine Q, add
// falls back to dbl-2009-l on P).  Here the selects are early returns
// that give the same result: P = inf returns Q first (its select is
// applied last, so it wins), then Q = inf returns P, and only a thread
// whose points are both finite runs the formula.  With the branch, no
// kernel holds all six coordinates to the end as the selects would; the
// add re-reads P from memory for its rare doubling (see add_core).
//
// Infinity as the accumulator's start is (one, one, 0), as in
// jacobian.infinity.

#pragma once

#include "bn254_field.cuh"

namespace bn254 {

template <class E>
struct Pt {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Pt<E> pt_infinity() {
  Pt<E> r;
  fone(r.x);
  fone(r.y);
  fzero_set(r.z);
  return r;
}

template <class E>
__device__ __forceinline__ Pt<E> pt_make(const E& x, const E& y,
                                         const E& z) {
  Pt<E> r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

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

// madd-2007-bl (_madd_core); Q.z must be 0 or the Montgomery one
template <class E>
__device__ __forceinline__ Pt<E> madd_core(const E& px, const E& py,
                                           const E& pz, const E& qx,
                                           const E& qy, const E& qz) {
  if (fzero(pz)) return pt_make(qx, qy, qz);
  if (fzero(qz)) return pt_make(px, py, pz);
  E z1z1 = fsqr(pz);
  E u2 = fmul(qx, z1z1);
  E s2 = fmul(fmul(qy, pz), z1z1);
  E h = fsub(u2, px);
  E rsub = fsub(s2, py);
  if (fzero(h))
    return fzero(rsub) ? double_affine_core(qx, qy) : pt_infinity<E>();
  E hh = fsqr(h);
  E i = fdbl(fdbl(hh));
  E j = fmul(h, i);
  E rr = fdbl(rsub);
  E v = fmul(px, i);
  Pt<E> r;
  r.x = fsub(fsub(fsqr(rr), j), fdbl(v));
  r.y = fsub(fmul(rr, fsub(v, r.x)), fdbl(fmul(py, j)));
  r.z = fmul(fdbl(pz), h);
  return r;
}

// add-2007-bl (_add_core).  `p_again()` returns P once more for the
// P = Q branch (dbl-2009-l on P): a caller that can re-read P from memory
// lets P's registers die after their last use in the formula, which is
// what keeps the G2 kernels under the register cap.  The products are
// taken in an order that lets each input die early: Q's X and Y after
// U2 and S2, P's after U1 and S1, both Z after the Z3 factor
// (Z1 + Z2)^2 - Z1Z1 - Z2Z2.
template <class E, class Reload>
__device__ __forceinline__ Pt<E> add_core(const E& px, const E& py,
                                          const E& pz, const E& qx,
                                          const E& qy, const E& qz,
                                          Reload p_again) {
  if (fzero(pz)) return pt_make(qx, qy, qz);
  if (fzero(qz)) return pt_make(px, py, pz);
  E z1z1 = fsqr(pz);
  E u2 = fmul(qx, z1z1);
  E s2 = fmul(fmul(qy, pz), z1z1);
  E z2z2 = fsqr(qz);
  E u1 = fmul(px, z2z2);
  E s1 = fmul(fmul(py, qz), z2z2);
  E zz = fsub(fsqr(fadd(pz, qz)), fadd(z1z1, z2z2));
  E h = fsub(u2, u1);
  E rsub = fsub(s2, s1);
  if (fzero(h)) {
    if (!fzero(rsub)) return pt_infinity<E>();
    Pt<E> p = p_again();
    return double_core(p.x, p.y, p.z);
  }
  E i = fsqr(fdbl(h));
  E j = fmul(h, i);
  E rr = fdbl(rsub);
  E v = fmul(u1, i);
  Pt<E> r;
  r.x = fsub(fsub(fsqr(rr), j), fdbl(v));
  r.y = fsub(fmul(rr, fsub(v, r.x)), fdbl(fmul(s1, j)));
  r.z = fmul(zz, h);
  return r;
}

// A point read that the compiler may not merge with an earlier read of
// the same words (for the re-reads above): word by word, volatile.
template <class E>
__device__ __forceinline__ E elem_again(const uint32_t* p) {
  constexpr int W = sizeof(E) / 4;
  const volatile uint32_t* q = p;
  E e;
  uint32_t* w = reinterpret_cast<uint32_t*>(&e);
#pragma unroll
  for (int k = 0; k < W; k++) w[k] = q[k];
  return e;
}

template <class E>
__device__ __forceinline__ Pt<E> pt_again(const Pt<E>& slot) {
  constexpr int W = sizeof(E) / 4;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&slot);
  return pt_make(elem_again<E>(w), elem_again<E>(w + W),
                 elem_again<E>(w + 2 * W));
}

template <class E>
__device__ __forceinline__ Pt<E> load_pt(const uint32_t* x, const uint32_t* y,
                                         const uint32_t* z, long long i) {
  return pt_make(load_elem<E>(x, i), load_elem<E>(y, i), load_elem<E>(z, i));
}

template <class E>
__device__ __forceinline__ Pt<E> load_pt_again(const uint32_t* x,
                                               const uint32_t* y,
                                               const uint32_t* z,
                                               long long i) {
  constexpr int W = sizeof(E) / 4;
  return pt_make(elem_again<E>(x + W * i), elem_again<E>(y + W * i),
                 elem_again<E>(z + W * i));
}

template <class E>
__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y, uint32_t* z,
                                         long long i, const Pt<E>& p) {
  store_elem(x, i, p.x);
  store_elem(y, i, p.y);
  store_elem(z, i, p.z);
}

}  // namespace bn254
