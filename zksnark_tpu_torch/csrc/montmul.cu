// K1: batched Montgomery multiplication out[i] = a[i] * b[i] * 2^-256 mod p
// over Fr or Fq (selected by argument), on (n, 8) u32-limb arrays.
//
// Replaces the Pallas kernel zksnark_tpu/ops/montmul.py:_kernel_body
// (launched by _pallas_fn at :59 through mont_mul_pallas and
// mont_mul_auto / from_mont_auto).  On the TPU that kernel ran the
// f32-digit field core on (512, 32) tiles with the MXU doing the
// fixed-operand passes.  Here each thread computes one product with the
// CIOS algorithm of bn254_field.cuh on 32-bit words in registers.
//
// Bound on the H100: each element reads 64 B and writes 32 B (96 B) for
// ~270 integer multiply-adds (8 x 8 words of a*b and of m*p, low and high
// halves, plus the 8 reductions), so at 3.35 TB/s and the card's integer
// rate the kernel is memory-bound at large n: 2^20 elements move 96 MiB,
// ~30 us.  The design does nothing more about it yet (one thread per
// element, 16-byte vector loads); fusing the multiplies into their
// consumers is later work.
//
// zk_montmul_add fuses two Fr products with broadcast operands and their
// sum (out = a x + b y), for the prover's blinded scalars; zk_wide_rows
// sums the products of a matrix's wide rows (a segmented sum of
// Montgomery products over CSR rows).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

template <class F>
__global__ void __launch_bounds__(256)
    montmul_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn254::Fe x = bn254::load_elem<bn254::Fe>(a, i);
  bn254::Fe y = bn254::load_elem<bn254::Fe>(b, i);
  bn254::Fe r;
  bn254::mont_mul<F>(r.v, x.v, y.v);
  bn254::store_elem(out, i, r);
}

// out[i] = (a[i] x + b[i] y) 2^-256 mod r, x = xy[0] and y = xy[1], over
// Fr: two products with broadcast operands and their sum in one pass (the
// prover's blinded scalars s u + r v).  Each element reads 64 B and
// writes 32 B, as one product does.
__global__ void __launch_bounds__(256)
    montmul_add_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       const uint32_t* __restrict__ xy,
                       uint32_t* __restrict__ out, long long n) {
  using F = bn254::FrField;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn254::Fe x = bn254::load_elem<bn254::Fe>(xy, 0);
  bn254::Fe y = bn254::load_elem<bn254::Fe>(xy, 1);
  bn254::Fe u = bn254::load_elem<bn254::Fe>(a, i);
  bn254::Fe v = bn254::load_elem<bn254::Fe>(b, i);
  bn254::Fe r;
  bn254::mont_mul<F>(u.v, u.v, x.v);
  bn254::mont_mul<F>(v.v, v.v, y.v);
  bn254::add_mod<F>(r.v, u.v, v.v);
  bn254::store_elem(out, i, r);
}

// The wide rows of a constraint matrix (those the prover's ELL leaves
// out, groth16/prover.py), in CSR: out[rows[r]] = sum over j in [ptr[r],
// ptr[r + 1]) of val[j] w[idx[j]] 2^-256 mod r, over Fr.  A group of g
// lanes (a power of two up to 32, inside one warp) takes a row: lane l
// the terms l, l + g, ..., accumulating in registers; the group's sums
// then meet by shuffles into lane 0, which writes the row.  Sums of
// canonical residues do not depend on their order, so the result is the
// plain version's bit for bit.  Each term reads a 4 B index, a 32 B value
// and a 32 B witness element; each row writes 32 B.
__global__ void __launch_bounds__(256)
    wide_rows_kernel(const uint32_t* __restrict__ w,
                     const int* __restrict__ idx,
                     const uint32_t* __restrict__ val,
                     const long long* __restrict__ ptr,
                     const long long* __restrict__ rows,
                     uint32_t* __restrict__ out, long long n_rows, int g) {
  using F = bn254::FrField;
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long r = t / g;
  int lane = (int)(t % g);
  bn254::Fe acc;
#pragma unroll
  for (int k = 0; k < 8; k++) acc.v[k] = 0;
  if (r < n_rows) {
    long long end = ptr[r + 1];
    for (long long j = ptr[r] + lane; j < end; j += g) {
      bn254::Fe a = bn254::load_elem<bn254::Fe>(val, j);
      bn254::Fe b = bn254::load_elem<bn254::Fe>(w, idx[j]);
      bn254::mont_mul<F>(a.v, a.v, b.v);
      bn254::add_mod<F>(acc.v, acc.v, a.v);
    }
  }
  // every lane of the warp takes part (blocks are whole warps and no lane
  // has returned); lane 0 of a group reads lanes below g only
  for (int off = g >> 1; off > 0; off >>= 1) {
    uint32_t o[8];
#pragma unroll
    for (int k = 0; k < 8; k++)
      o[k] = __shfl_down_sync(0xffffffffu, acc.v[k], off, g);
    bn254::add_mod<F>(acc.v, acc.v, o);
  }
  if (r < n_rows && lane == 0) bn254::store_elem(out, rows[r], acc);
}

}  // namespace

extern "C" int zk_wide_rows(const void* w, const void* idx, const void* val,
                            const void* ptr, const void* rows, void* out,
                            long long n_rows, int g, void* stream) {
  if (n_rows <= 0) return 0;
  if (g < 1 || g > 32 || (g & (g - 1))) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long lanes = n_rows * g;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  wide_rows_kernel<<<blocks, threads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const int*>(idx),
      static_cast<const uint32_t*>(val), static_cast<const long long*>(ptr),
      static_cast<const long long*>(rows), static_cast<uint32_t*>(out),
      n_rows, g);
  return (int)cudaGetLastError();
}

extern "C" int zk_montmul_add(const void* a, const void* b, const void* xy,
                              void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  montmul_add_kernel<<<blocks, threads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(xy), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int zk_montmul(const void* a, const void* b, void* out,
                          long long n, int field, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  if (field == 0)
    montmul_kernel<bn254::FrField><<<blocks, threads, 0, s>>>(pa, pb, po, n);
  else
    montmul_kernel<bn254::FqField><<<blocks, threads, 0, s>>>(pa, pb, po, n);
  return (int)cudaGetLastError();
}
