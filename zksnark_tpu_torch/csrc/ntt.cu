// The radix-2 NTT over BN254 Fr with K1's twiddle product inside each
// butterfly: the stages run in passes, each pass one launch.
//
// Replaces the NTT stage loop of zksnark_tpu/ops/ntt.py
// (_butterflies_unrolled :213-240, _butterflies :167-197), where every
// stage launches the Pallas montmul kernel (ops/montmul.py _kernel_body,
// pallas_call at :59) for its twiddle products and leaves the adds and
// subtracts, the bit-reversal gather (_bitrev_take :157) and the
// re-layout between stages to XLA.
//
// The transform is the in-order-output DIT of those loops: bit-reversed
// input, then stages s = 1 .. log_n, where stage s pairs the indices i
// and i + 2^(s-1) (bit s - 1 of i clear) and sets
//   t = w v,  (u, v) <- (u + t, u - t),  w = omega^((i mod 2^(s-1)) n/2^s)
// with w read from the domain's power table (tw[j] = omega^j, j < n/2).
// Stages s0 .. s0 + k - 1 pair indices that differ in bits s0 - 1 ..
// s0 + k - 2 only, so they split the array into independent groups of
// G = 2^k elements:
//   i = hi 2^(s0-1+k) + mid 2^(s0-1) + lo,   group (hi, lo), element mid,
// and at stage s0 + r the pairs of a group differ in bit r of mid.  A
// pass loads each group into shared memory once, runs its k stages there
// (one butterfly per thread per stage, a barrier between stages) and
// stores it once.  With k <= 10 a transform of 2^20 takes two passes
// where the loop took 20 stages of a montmul launch plus the add/sub glue.
// The first pass reads its input through the bit reversal; later passes
// run in place (a block writes only the group it read).
//
// Each butterfly is bn254::mont_mul<FrField> (CIOS) and the canonical add
// and subtract of bn254_field.cuh, on the Montgomery residues of the JAX
// package: results are the same canonical residues, bit for bit.
//
// Bound on the H100: integer throughput.  A 2^20 transform is 20 x 2^19
// Montgomery products (~264 multiply-adds each, ~0.165 ms at the card's
// integer rate) against two passes over 32 MB, read and written (~0.04
// ms).  A block holds up to 2^10 elements (32 KB); the elements are 32 B,
// one memory sector each, so the strided and bit-reversed accesses waste
// no sector.  The twiddles come from the 16 MB table through L2.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the caller's stream and never synchronises.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int kMaxPassLog = 10;             // k <= 10: 2^10 elements
constexpr int kMaxElems = 1 << kMaxPassLog;  // per block

__device__ __forceinline__ void load8(uint32_t r[8], const uint32_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t r[8]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// One pass over stages s0 .. s0 + k - 1 of a 2^log_n transform.  A block
// holds `elems` = blockDim.x * 2 elements: elems / 2^k whole groups, with
// consecutive group numbers g = hi 2^(s0-1) + lo.  in may equal out.
__global__ void __launch_bounds__(kMaxElems / 2)
    ntt_pass_kernel(const uint32_t* in, uint32_t* out,
                    const uint32_t* __restrict__ tw, int log_n, int s0,
                    int k, int bitrev) {
  __shared__ uint32_t sm[kMaxElems * 8];
  const int elems = 2 * blockDim.x;
  const int lo_bits = s0 - 1;
  const long long lo_mask = (1LL << lo_bits) - 1;
  const long long g0 = (long long)blockIdx.x * (elems >> k);

  // element e of the block: group g0 + e / 2^k, mid = e mod 2^k
  auto index = [&](int e) {
    const long long g = g0 + (e >> k);
    const long long mid = e & ((1 << k) - 1);
    return ((g >> lo_bits) << (lo_bits + k)) | (mid << lo_bits) |
           (g & lo_mask);
  };

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    long long i = index(e);
    if (bitrev) i = __brev((unsigned)i) >> (32 - log_n);
    uint32_t x[8];
    load8(x, in + 8 * i);
    store8(sm + 8 * e, x);
  }
  __syncthreads();

  // butterfly q: group q / 2^(k-1) of the block, pair bq of that group
  const int q = threadIdx.x;
  const int half = 1 << (k - 1);
  const int base = (q >> (k - 1)) << k;
  const int bq = q & (half - 1);
  const long long lo = (g0 + (q >> (k - 1))) & lo_mask;
  for (int r = 0; r < k; r++) {
    const int low = bq & ((1 << r) - 1);
    const int eu = base + (((bq >> r) << (r + 1)) | low);
    const int ev = eu + (1 << r);
    // i mod 2^(s-1) at s = s0 + r is (mid mod 2^r) 2^(s0-1) + lo
    const long long j = ((long long)low << lo_bits) | lo;
    uint32_t u[8], v[8], w[8], t[8];
    load8(u, sm + 8 * eu);
    load8(v, sm + 8 * ev);
    load8(w, tw + 8 * (j << (log_n - s0 - r)));
    bn254::mont_mul<bn254::FrField>(t, w, v);
    bn254::add_mod<bn254::FrField>(w, u, t);
    bn254::sub_mod<bn254::FrField>(v, u, t);
    store8(sm + 8 * eu, w);
    store8(sm + 8 * ev, v);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    uint32_t x[8];
    load8(x, sm + 8 * e);
    store8(out + 8 * index(e), x);
  }
}

}  // namespace

// One pass of a 2^log_n transform over (n, 8) u32-limb Fr arrays: stages
// s0 .. s0 + k - 1 (1 <= k <= 10), `elems` elements per block (a power
// of two with 2^k <= elems <= min(n, 2^10)); the input is read
// bit-reversed when bitrev is set.  out may equal in (not when bitrev).
extern "C" int zk_ntt_pass(const void* in, void* out, const void* tw,
                           int log_n, int s0, int k, int bitrev, int elems,
                           void* stream) {
  const long long n = 1LL << log_n;
  if (log_n < 1 || log_n > 31 || k < 1 || k > kMaxPassLog || s0 < 1 ||
      s0 + k - 1 > log_n || elems < (1 << k) || elems > kMaxElems ||
      (elems & (elems - 1)) || elems > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  ntt_pass_kernel<<<(unsigned)(n / elems), elems / 2, 0, s>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), log_n, s0, k, bitrev);
  return (int)cudaGetLastError();
}
