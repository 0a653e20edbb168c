// BN254 field arithmetic for the Hopper kernels: Fr and Fq on 8 x u32
// limbs, Fq2 = Fq[u]/(u^2 + 1) on pairs of them.
//
// Counterpart of the TPU package's in-kernel field core
// (zksnark_tpu/ops/fieldcore.py: mont_mul_dm, add_dm, sub_dm, is_zero_dm,
// cond_sub_p), which every Pallas kernel inlines.  That core is shaped by
// the TPU (8-bit digits in f32 lanes, MXU Toeplitz matmuls, Kogge-Stone
// carries); none of it carries over.  Here one thread holds whole field
// elements in registers and runs the textbook algorithms on 32-bit words:
//
//  - Montgomery multiplication is CIOS (coarsely integrated operand
//    scanning): for each word b_i of b, t += a * b_i, then
//    m = t_0 * n0' mod 2^32 and t = (t + m * p) / 2^32.  Each
//    multiply-accumulate row is one PTX carry chain
//    (mad.lo.cc / madc.lo.cc for the low halves, mad.hi.cc / madc.hi.cc
//    for the high halves) kept inside one asm block, because the carry
//    flag does not survive between asm statements.  p < 2^254 < R/4, so t
//    stays below 2p and one conditional subtract makes the result
//    canonical.
//  - add: a + b with an add.cc chain, then subtract p if the sum >= p.
//  - sub: a - b with a sub.cc chain, and add p back on a borrow.
//
// Inputs and outputs are canonical residues in [0, p), in Montgomery form
// with R = 2^256, exactly as in the JAX package, so results are the same
// 256-bit numbers bit for bit.  The modulus is a template parameter
// (FrField or FqField).

#pragma once
#include <cstdint>

namespace bn254 {

struct FrField {
  static constexpr uint32_t N0 = 0xefffffffu;  // -r^-1 mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                               0x2833e848u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return P[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod r
    constexpr uint32_t O[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u,
                               0x36fc7695u, 0x7879462eu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
};

struct FqField {
  static constexpr uint32_t N0 = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                               0x97816a91u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return P[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod q
    constexpr uint32_t O[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                               0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
};

// t[0..9] += a[0..7] * b.  Low halves land on t[j], high halves on
// t[j + 1]; the two carry chains end in t[9].
__device__ __forceinline__ void mac_row(uint32_t t[10], const uint32_t a[8],
                                        uint32_t b) {
  asm("mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// d = a - b over 8 words; returns 0xffffffff on a borrow, else 0.
__device__ __forceinline__ uint32_t sub_words(uint32_t d[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t borrow;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(0u));
  return borrow;
}

// d = a + b over 8 words; the carry out is dropped.
__device__ __forceinline__ void add_words(uint32_t d[8], const uint32_t a[8],
                                          const uint32_t b[8]) {
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

template <class F>
__device__ __forceinline__ void load_p(uint32_t p[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] = F::p(j);
}

// r = t >= p ? t - p : t   (t < 2p)
template <class F>
__device__ __forceinline__ void cond_sub_p(uint32_t r[8], const uint32_t t[8]) {
  uint32_t p[8], d[8];
  load_p<F>(p);
  uint32_t borrow = sub_words(d, t, p);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? t[j] : d[j];
}

// r = a * b * 2^-256 mod p (CIOS).  r may alias a or b.
//
// The loop over b's words is not unrolled: unrolled, one product is ~330
// instructions, a point formula inlines 16 (G1 add) to 48 (G2 add) of
// them, and a loop body of that size outgrows the SM's instruction cache,
// which tripled a thread's time per instruction.  Rolled, a product is
// ~60 instructions; each pass moves t and b down one word instead of
// renaming them.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t p[8], t[10], bs[8];
  load_p<F>(p);
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) bs[j] = b[j];
#pragma unroll 1
  for (int i = 0; i < 8; i++) {
    mac_row(t, a, bs[0]);
    uint32_t m = t[0] * F::N0;
    mac_row(t, p, m);  // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < 9; j++) t[j] = t[j + 1];
    t[9] = 0;
#pragma unroll
    for (int j = 0; j < 7; j++) bs[j] = bs[j + 1];
  }
  cond_sub_p<F>(r, t);  // t < 2p < 2^256: t[8] is 0 here
}

// r = (a + b) mod p
template <class F>
__device__ __forceinline__ void add_mod(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8]) {
  uint32_t s[8];
  add_words(s, a, b);  // a + b < 2p < 2^256
  cond_sub_p<F>(r, s);
}

// r = (a - b) mod p
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8]) {
  uint32_t p[8], d[8], e[8];
  load_p<F>(p);
  uint32_t borrow = sub_words(d, a, b);
  add_words(e, d, p);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? e[j] : d[j];
}

// ---------------------------------------------------------------------------
// Value types for the point kernels: Fe is an Fq element, Fe2 an Fq2
// element (c0 + c1 u, stored c0 then c1 as in the (..., 2, 8) tensors).
// ---------------------------------------------------------------------------

struct Fe {
  uint32_t v[8];
};
struct Fe2 {
  Fe c0, c1;
};

__device__ __forceinline__ Fe fmul(const Fe& a, const Fe& b) {
  Fe r;
  mont_mul<FqField>(r.v, a.v, b.v);
  return r;
}
__device__ __forceinline__ Fe fadd(const Fe& a, const Fe& b) {
  Fe r;
  add_mod<FqField>(r.v, a.v, b.v);
  return r;
}
__device__ __forceinline__ Fe fsub(const Fe& a, const Fe& b) {
  Fe r;
  sub_mod<FqField>(r.v, a.v, b.v);
  return r;
}
__device__ __forceinline__ Fe fsqr(const Fe& a) { return fmul(a, a); }
__device__ __forceinline__ Fe fdbl(const Fe& a) { return fadd(a, a); }
__device__ __forceinline__ bool fzero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) acc |= a.v[j];
  return acc == 0;
}
__device__ __forceinline__ Fe fsel(bool m, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = m ? a.v[j] : b.v[j];
  return r;
}
__device__ __forceinline__ void fone(Fe& r) {
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = FqField::one(j);
}
__device__ __forceinline__ void fzero_set(Fe& r) {
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = 0;
}

// Fq2: 3-multiplication Karatsuba, the formulas of the TPU kernel
// (zksnark_tpu/ops/curve_pallas.py: _KFq2.mul / .sqr).
__device__ __forceinline__ Fe2 fmul(const Fe2& a, const Fe2& b) {
  Fe t0 = fmul(a.c0, b.c0);
  Fe t1 = fmul(a.c1, b.c1);
  Fe t2 = fmul(fadd(a.c0, a.c1), fadd(b.c0, b.c1));
  Fe2 r;
  r.c0 = fsub(t0, t1);
  r.c1 = fsub(fsub(t2, t0), t1);
  return r;
}
__device__ __forceinline__ Fe2 fsqr(const Fe2& a) {
  Fe2 r;
  r.c0 = fmul(fadd(a.c0, a.c1), fsub(a.c0, a.c1));
  r.c1 = fmul(fdbl(a.c0), a.c1);
  return r;
}
__device__ __forceinline__ Fe2 fadd(const Fe2& a, const Fe2& b) {
  Fe2 r;
  r.c0 = fadd(a.c0, b.c0);
  r.c1 = fadd(a.c1, b.c1);
  return r;
}
__device__ __forceinline__ Fe2 fsub(const Fe2& a, const Fe2& b) {
  Fe2 r;
  r.c0 = fsub(a.c0, b.c0);
  r.c1 = fsub(a.c1, b.c1);
  return r;
}
__device__ __forceinline__ Fe2 fdbl(const Fe2& a) { return fadd(a, a); }
__device__ __forceinline__ bool fzero(const Fe2& a) {
  return fzero(a.c0) && fzero(a.c1);
}
__device__ __forceinline__ Fe2 fsel(bool m, const Fe2& a, const Fe2& b) {
  Fe2 r;
  r.c0 = fsel(m, a.c0, b.c0);
  r.c1 = fsel(m, a.c1, b.c1);
  return r;
}
__device__ __forceinline__ void fone(Fe2& r) {
  fone(r.c0);
  fzero_set(r.c1);
}
__device__ __forceinline__ void fzero_set(Fe2& r) {
  fzero_set(r.c0);
  fzero_set(r.c1);
}

// Element loads and stores: an element is W = 8 (Fe) or 16 (Fe2)
// consecutive u32 words, read and written as 16-byte vectors (the
// wrappers pass 16-byte aligned, contiguous tensors).
template <class E>
__device__ __forceinline__ E load_elem(const uint32_t* base, long long i) {
  constexpr int W = sizeof(E) / 4;
  const uint4* q = reinterpret_cast<const uint4*>(base + W * i);
  E e;
  uint32_t* w = reinterpret_cast<uint32_t*>(&e);
#pragma unroll
  for (int k = 0; k < W / 4; k++) {
    uint4 x = q[k];
    w[4 * k] = x.x;
    w[4 * k + 1] = x.y;
    w[4 * k + 2] = x.z;
    w[4 * k + 3] = x.w;
  }
  return e;
}

template <class E>
__device__ __forceinline__ void store_elem(uint32_t* base, long long i,
                                           const E& e) {
  constexpr int W = sizeof(E) / 4;
  uint4* q = reinterpret_cast<uint4*>(base + W * i);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&e);
#pragma unroll
  for (int k = 0; k < W / 4; k++)
    q[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

}  // namespace bn254
