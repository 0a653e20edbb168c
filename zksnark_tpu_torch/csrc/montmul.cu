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

}  // namespace

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
