// K2 in a chain: fixed-base comb encryption E(s_i) = s_i * base on BN254
// G1 (over Fq) or G2 (over Fq2), one thread per scalar, one launch for
// all of them:
//
//   acc = infinity; for w = 0 .. 31 (window 0 first):
//     acc = madd(acc, T[w, byte w of s_i])
//
// with T[w, d] = d * 2^(8 w) * base from the (32, 256) affine comb table
// (every entry affine or infinity, Z in {0, one}).
//
// Replaces the chain of the Pallas kernel
// zksnark_tpu/ops/curve_pallas.py:_madd_kernel (:291, core _madd_core
// :169, launched by _point_call :337) in setup's comb encryption: the JAX
// package's _comb_encrypt_impl (zksnark_tpu/groth16/prover.py:206) is a
// lax.scan of that kernel, one gather of the window's table entries and
// one launch per window, and the accumulator makes 31 round trips through
// device memory.  Here each thread reads its scalar's 8 standard-form u32
// limbs once, takes each byte in registers, keeps the accumulator in
// registers for the 32 mixed adds (madd_core of point_core.cuh, the
// formulas and window order of the TPU kernel, so the raw Jacobian output
// is that of the scan bit for bit) and writes it once.
//
// Bound on the H100: operations.  A scalar costs 32 mixed adds (G1: ~11
// Fq products each; G2: ~3x that), so 2^20 G1 scalars are ~32 x 0.19 ms
// of the card's integer rate and 2^20 G2 scalars ~32 x 0.57 ms; the bytes
// (scalars in, one point out, the 512 KB or 1 MB table) are ~1 % of that.
// The table is read from global memory: the threads of a block walk the
// windows together and all read the same 16 KB (G1) or 32 KB (G2) row of
// X and Y, so the loads hit L1 or L2.  (Staging each window's rows in
// shared memory with cp.async was measured too and gained nothing
// end to end: PERF.md.)
//
// Layout: table coordinates (32, 256, W) u32 words, W = 8 (G1) or 16
// (G2); scalars (m, 8) u32 limbs of standard-form values below 2^256;
// outputs (m, W).  Every array contiguous and 16-byte aligned.
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
constexpr int kDigits = 256;  // entries of a window's row

__device__ __forceinline__ void load_scalar(uint32_t s[8],
                                            const uint32_t* scalars,
                                            long long i) {
  const uint4* q = reinterpret_cast<const uint4*>(scalars + 8 * i);
  uint4 a = q[0], b = q[1];
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    comb_kernel(const uint32_t* __restrict__ tx,
                const uint32_t* __restrict__ ty,
                const uint32_t* __restrict__ tz,
                const uint32_t* __restrict__ scalars, uint32_t* ox,
                uint32_t* oy, uint32_t* oz, long long m) {
  constexpr int kRowWords = kDigits * (int)(sizeof(E) / 4);
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t s[8];
  load_scalar(s, scalars, i);
  Pt<E> acc = bn254::pt_infinity<E>();
  long long row = 0;  // word offset of window w's row
  // the limbs move down one a pass (as the Montgomery loop moves its
  // operand), so no register array is indexed by a loop variable
#pragma unroll 1
  for (int k = 0; k < 8; k++) {
    uint32_t word = s[0];
#pragma unroll
    for (int j = 0; j < 7; j++) s[j] = s[j + 1];
#pragma unroll 1
    for (int b = 0; b < 4; b++) {
      Pt<E> q = bn254::load_pt<E>(tx + row, ty + row, tz + row,
                                  word & 0xffu);
      acc = bn254::madd_core(acc.x, acc.y, acc.z, q.x, q.y, q.z);
      word >>= 8;
      row += kRowWords;
    }
  }
  bn254::store_pt(ox, oy, oz, i, acc);
}

template <class E>
int launch(const void* tx, const void* ty, const void* tz,
           const void* scalars, void* ox, void* oy, void* oz, long long m,
           cudaStream_t s) {
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto out = [](void* p) { return static_cast<uint32_t*>(p); };
  comb_kernel<E><<<blocks, kThreads, 0, s>>>(
      in(tx), in(ty), in(tz), in(scalars), out(ox), out(oy), out(oz), m);
  return (int)cudaGetLastError();
}

}  // namespace

// g2: 0 for G1, 1 for G2
extern "C" int zk_point_comb(int g2, const void* tx, const void* ty,
                             const void* tz, const void* scalars, void* ox,
                             void* oy, void* oz, long long m, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (g2) return launch<Fe2>(tx, ty, tz, scalars, ox, oy, oz, m, s);
  return launch<Fe>(tx, ty, tz, scalars, ox, oy, oz, m, s);
}
