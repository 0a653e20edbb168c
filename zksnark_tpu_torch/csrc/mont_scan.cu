// K1 in batch_normalize (curve/jacobian.py): Montgomery's trick on a
// batch of Fq (G1) or Fq2 (G2) Jacobian points, as two prefix-product
// chains and one pass over the points, two kernels:
//
// zk_mont_scan: inclusive prefix products along the c axis of a (B, c)
// grid of Montgomery residues, one launch per grid:
//
//   acc = carry[b] (or the Montgomery one); for j < c:
//     acc = acc * x[b, j];  out[b, j] = acc
//   totals[b] = acc
//
// zk_normalize: with pre[i] = z_0 ... z_i and suf[i] = z_i ... z_{n-1}
// (the points' Z, one in place of an infinite point's 0) and tinv the
// inverse of their grand product, every point at once:
//
//   zinv = pre[i - 1] suf[i + 1] tinv;  x' = x zinv^2;  y' = y zinv^3;
//   z' = one;  or (one, one, 0) where z = 0
//
// Replace, in batch_normalize, the Pallas kernel
// zksnark_tpu/ops/montmul.py:_kernel_body (launched by _pallas_fn at
// :59): the JAX package's _prefix_prod (zksnark_tpu/curve/jacobian.py
// :203) is a lax.scan of that kernel, one launch per step of a c = 64
// chain at every level, and its _bn_apply (:296) six more products.
//
// Bound on the H100.  A scan of n elements costs n Montgomery products
// (3n for Fq2, Karatsuba), ~264 multiply-adds each, and moves 64 B an Fq
// element (x read, the prefix written): 2^20 Fq products are ~17 us of
// the card's integer rate.  What holds a chain back is latency: one
// product is a few hundred dependent instructions (~1 us), and a chain
// of c products per thread is c of them.  So one block of 128 threads
// scans one row: each thread takes the product of its ceil(c / 128)
// consecutive elements, the block scans those 128 products (five rounds
// of warp shuffles, then the warps' totals), and each thread then writes
// its elements' prefixes from its exclusive start.  A row of 2048 costs a
// thread 16 + ~9 + 16 dependent products, and a 2^20 prefix product takes
// three launches (curve/jacobian.py _prefix_prod): the 512 rows' totals,
// one row of those 512 totals for the rows' carries, and the rows again
// from their carries with every prefix written.  zk_normalize is one
// thread a point, six products and 7 elements of traffic (x, y, z, two
// neighbours' prefixes in, x', y', z' out): bound by bytes for Fq and
// near the balance for Fq2; in place of six product launches and, for
// Fq2, the plain-PyTorch additions of the Karatsuba around each.
// Each product is reduced below p (bn254_field.cuh), so neither the
// order of the products nor the formula changes a byte: the results are
// the JAX package's.
//
// Layout: x and out are (B * c) elements, row-major (row b is elements
// [b c, b c + c)); carry and totals are B elements; the points' x, y, z,
// pre and suf n elements, tinv one.  An element is 8 (Fq) or 16 (Fq2)
// u32 words; every array contiguous and 16-byte aligned.  carry and out
// may be null.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

using bn254::Fe;
using bn254::Fe2;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <class E>
__device__ __forceinline__ E shfl_up(const E& v, int d) {
  constexpr int W = sizeof(E) / 4;
  E r;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < W; k++) o[k] = __shfl_up_sync(0xffffffffu, s[k], d);
  return r;
}

// The product of v over the block's threads before this one (the one for
// thread 0).  Every thread of the block must call it.
template <class E>
__device__ __forceinline__ E block_exclusive(const E& v) {
  __shared__ E warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  E inc = v;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    E up = shfl_up(inc, d);
    if (lane >= d) inc = bn254::fmul(up, inc);
  }
  if (lane == 31) warp_total[warp] = inc;
  E ex = shfl_up(inc, 1);
  if (lane == 0) bn254::fone(ex);
  __syncthreads();
#pragma unroll 1
  for (int w = warp - 1; w >= 0; w--) ex = bn254::fmul(warp_total[w], ex);
  return ex;
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    mont_scan_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ carry,
                     uint32_t* __restrict__ out, uint32_t* __restrict__ totals,
                     int c) {
  const long long row = blockIdx.x;
  const int k = (c + kThreads - 1) / kThreads;  // elements a thread
  const int lo = min(c, (int)threadIdx.x * k), hi = min(c, lo + k);
  const long long base = row * c;
  E local;
  bn254::fone(local);
#pragma unroll 1
  for (int j = lo; j < hi; j++)
    local = bn254::fmul(local, bn254::load_elem<E>(x, base + j));
  E acc = block_exclusive(local);
  if (carry) acc = bn254::fmul(bn254::load_elem<E>(carry, row), acc);
  if (threadIdx.x == kThreads - 1)
    bn254::store_elem(totals, row, bn254::fmul(acc, local));
  if (!out) return;
#pragma unroll 1
  for (int j = lo; j < hi; j++) {
    acc = bn254::fmul(acc, bn254::load_elem<E>(x, base + j));
    bn254::store_elem(out, base + j, acc);
  }
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ z,
                     const uint32_t* __restrict__ pre,
                     const uint32_t* __restrict__ suf,
                     const uint32_t* __restrict__ tinv, uint32_t* ox,
                     uint32_t* oy, uint32_t* oz, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  E one, zero;
  bn254::fone(one);
  bn254::fzero_set(zero);
  if (bn254::fzero(bn254::load_elem<E>(z, i))) {
    bn254::store_elem(ox, i, one);
    bn254::store_elem(oy, i, one);
    bn254::store_elem(oz, i, zero);
    return;
  }
  E before = i > 0 ? bn254::load_elem<E>(pre, i - 1) : one;
  E after = i + 1 < n ? bn254::load_elem<E>(suf, i + 1) : one;
  E zinv = bn254::fmul(bn254::fmul(before, after),
                       bn254::load_elem<E>(tinv, 0));
  E zi2 = bn254::fmul(zinv, zinv);
  E zi3 = bn254::fmul(zi2, zinv);
  bn254::store_elem(ox, i, bn254::fmul(bn254::load_elem<E>(x, i), zi2));
  bn254::store_elem(oy, i, bn254::fmul(bn254::load_elem<E>(y, i), zi3));
  bn254::store_elem(oz, i, one);
}

}  // namespace

// fq2: 0 for Fq, 1 for Fq2.  carry, out: null for none.
extern "C" int zk_mont_scan(int fq2, const void* x, const void* carry,
                            void* out, void* totals, long long rows, int c,
                            void* stream) {
  if (rows <= 0 || c <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)rows;
  const uint32_t* px = static_cast<const uint32_t*>(x);
  const uint32_t* pc = static_cast<const uint32_t*>(carry);
  uint32_t* po = static_cast<uint32_t*>(out);
  uint32_t* pt = static_cast<uint32_t*>(totals);
  if (fq2)
    mont_scan_kernel<Fe2><<<blocks, kThreads, 0, s>>>(px, pc, po, pt, c);
  else
    mont_scan_kernel<Fe><<<blocks, kThreads, 0, s>>>(px, pc, po, pt, c);
  return (int)cudaGetLastError();
}

// fq2: 0 for Fq, 1 for Fq2; outputs may not alias the inputs
extern "C" int zk_normalize(int fq2, const void* x, const void* y,
                            const void* z, const void* pre, const void* suf,
                            const void* tinv, void* ox, void* oy, void* oz,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto out = [](void* p) { return static_cast<uint32_t*>(p); };
  if (fq2)
    normalize_kernel<Fe2><<<blocks, kThreads, 0, s>>>(
        in(x), in(y), in(z), in(pre), in(suf), in(tinv), out(ox), out(oy),
        out(oz), n);
  else
    normalize_kernel<Fe><<<blocks, kThreads, 0, s>>>(
        in(x), in(y), in(z), in(pre), in(suf), in(tinv), out(ox), out(oy),
        out(oz), n);
  return (int)cudaGetLastError();
}
