// K2, K3 and K4 as the MSM runs them: sequential chains of point
// operations, each in one launch, on BN254 G1 (over Fq) and G2 (over Fq2).
//
//   K2  bucket_scan  the Pippenger bucket scan of every window of one MSM:
//                 one thread per (window, chunk of c sorted positions)
//                 reads its points through the sort permutation, keeps
//                 the running sum in registers and writes it only where a
//                 digit's run ends, into that digit's bucket slot.
//                 Replaces _bucket_window_sorted's window gather, its
//                 chunked scan and its scatter into bucket slots
//                 (zksnark_tpu/ops/msm.py:311-360), whose every scan step
//                 is a launch of the Pallas _madd_kernel
//                 (ops/curve_pallas.py:291) or _add_kernel (:281).
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
// copy is in flight while step j adds.
//
// bucket_scan layout: the points are an (n,) table; `order` and the
// sorted digits `dsorted` are (nwin, n) int64, each window's digits in
// ascending order and order[w, k] the table row of window w's k-th
// smallest digit.  Lane l = w * b + k owns window w's positions
// [k c, k c + c) (b = ceil(n / c) chunks; positions at or past n are
// infinity, the appended point of the JAX package), so the lanes of a
// block own one contiguous range of the flat (nwin, n) arrays.  The block
// stages that range in shared memory a tile of kBucketTile positions at
// a time, coalesced (a thread loads entries of the block's lanes, not of
// its own), narrowed to u32 (a row index or digit: the wrapper checks
// that n < 2^32 and that every digit lies in [0, nb); that `order` is a
// permutation of the rows is a precondition), with one more digit per
// lane than it walks: position k c + c, the next chunk's first, says
// whether the lane's last position ends a run.  Each lane then stages its next point by cp.async as add_scan
// does, X and Y in full and, for the mixed add, only the first 16 bytes
// of Z: under the affine invariant Z is 0 or the Montgomery one, whose
// low word is not 0.  The running sum is madd_core (affine table) or
// add_core, in the order of the JAX package's scan.  Where position k
// ends its digit's run (the next sorted digit differs, or k = n - 1) the
// lane writes the running sum to slot (w, d), its chunk index to
// chunk[w, d] and 1 to valid[w, d]: every digit's run ends once, so no
// two lanes write one slot, and slots of empty buckets keep what the
// wrapper put there (infinity, chunk 0, not valid).  totals (b, nwin)
// gets every lane's sum.
//
// Bound on the H100: at many lanes (2^14 lanes x 64 steps, and the bucket
// scan's 2^18) integer throughput, as for the elementwise add and madd;
// at few lanes (64 lanes, 16 window totals, one Horner thread) the
// latency of one thread's chain of dependent Montgomery products: c steps
// of one add each, or W (c + 1) point operations for Horner.  The bucket
// scan moves the points once (random rows of a table of 64 MB for G1
// against a 50 MB L2) for 2^24 madds per MSM at c = 16.
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
constexpr int kBucketThreads = 64;
constexpr int kBucketTile = 16;  // positions staged per tile

using bn254::cp_async16;
using bn254::cp_async_commit;
using bn254::cp_async_wait;

// (b, c, r) grid: the point index of lane l at position 0; position j
// is j * r further.  Grids hold fewer than 2^31 points (zk_point_add_scan
// refuses larger ones).
__device__ __forceinline__ unsigned grid_base(long long l, int c,
                                              long long r) {
  return (unsigned)((l / r) * c * r + l % r);
}

template <class E>
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
    saved[threadIdx.x] = acc;
    acc = bn254::add_core(acc.x, acc.y, acc.z, qx, qy, qz, [&] {
      return bn254::pt_again(saved[threadIdx.x]);
    });
    if (collect) bn254::store_pt(wx, wy, wz, own + j * step, acc);
  }
  bn254::store_pt(tx, ty, tz, l, acc);
}

// One lane per (window, chunk); see the layout notes at the top.  Every
// thread of the block takes part in the tile loads and barriers, also
// those past the last lane, which skip the arithmetic.  The minimum of
// 11 (G1) or 6 (G2) blocks per SM caps the registers at those of the
// elementwise madd or below (80 and 168, with small spills); uncapped,
// ptxas takes 111 and 192.  probe_register_caps.py times the variants:
// the G1 cap costs a few percent of the G1 scan, the G2 cap gains a
// little (PERF.md).
template <class E, bool MIXED>
__global__ void __launch_bounds__(kBucketThreads,
                                 sizeof(E) == sizeof(Fe) ? 11 : 6)
    bucket_scan_kernel(const uint32_t* __restrict__ px,
                       const uint32_t* __restrict__ py,
                       const uint32_t* __restrict__ pz,
                       const long long* __restrict__ order,
                       const long long* __restrict__ dsorted, uint32_t* sx,
                       uint32_t* sy, uint32_t* sz, long long* chunk,
                       uint8_t* valid, uint32_t* tx, uint32_t* ty,
                       uint32_t* tz, int nwin, long long n, int c,
                       long long b, int nb) {
  constexpr int W = sizeof(E) / 4;  // u32 words per coordinate
  constexpr int V = W / 4;          // 16-byte pieces per coordinate
  constexpr int VZ = MIXED ? 1 : V;  // pieces of Z staged
  constexpr int S = kBucketTile;
  __shared__ uint32_t tile_idx[kBucketThreads][S + 1];
  __shared__ uint32_t tile_dig[kBucketThreads][S + 1];
  __shared__ uint4 stage_xy[2][2][kBucketThreads * V];
  __shared__ uint4 stage_z[2][kBucketThreads * VZ];
  __shared__ Pt<E> saved[MIXED ? 1 : kBucketThreads];  // for P = Q (add)

  const long long lanes = (long long)nwin * b;
  const long long l0 = (long long)blockIdx.x * kBucketThreads;
  const long long l = l0 + threadIdx.x;
  const bool active = l < lanes;
  const long long w = active ? l / b : 0;
  const long long k = active ? l % b : 0;
  const long long first = k * c;  // the lane's first position

  // Stage position first + j (tile column col = j - t0) in buffer buf:
  // its point by cp.async, or infinity (one, one, 0) past n.
  auto fetch = [&](int buf, int col, bool live) {
    if (live) {
      const size_t at = (size_t)tile_idx[threadIdx.x][col] * W;
#pragma unroll
      for (int q = 0; q < 2 * V; q++)
        cp_async16(&stage_xy[buf][q / V][threadIdx.x * V + q % V],
                   (q / V == 0 ? px : py) + at + 4 * (q % V));
#pragma unroll
      for (int q = 0; q < VZ; q++)
        cp_async16(&stage_z[buf][threadIdx.x * VZ + q], pz + at + 4 * q);
    } else {
      E one;
      bn254::fone(one);
      reinterpret_cast<E*>(stage_xy[buf][0])[threadIdx.x] = one;
      reinterpret_cast<E*>(stage_xy[buf][1])[threadIdx.x] = one;
#pragma unroll
      for (int q = 0; q < VZ; q++)
        stage_z[buf][threadIdx.x * VZ + q] = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();  // an empty group when not live: the waits count
  };

  Pt<E> acc = bn254::pt_infinity<E>();
  for (int t0 = 0; t0 < c; t0 += S) {
    __syncthreads();  // every lane is done with the previous tile
    for (int e = threadIdx.x; e < kBucketThreads * (S + 1);
         e += kBucketThreads) {
      const int li = e / (S + 1), col = e % (S + 1);
      const long long ll = l0 + li;
      if (ll >= lanes) continue;
      const long long pos = (ll % b) * c + t0 + col;
      if (pos >= n) continue;
      const long long f = (ll / b) * n + pos;
      tile_idx[li][col] = (uint32_t)order[f];
      tile_dig[li][col] = (uint32_t)dsorted[f];
    }
    __syncthreads();
    if (!active) continue;
    if (t0 == 0) fetch(0, 0, first < n);
    for (int col = 0; col < S && t0 + col < c; col++) {
      const int j = t0 + col;
      const long long pos = first + j;
      if (j + 1 < c) {
        fetch((j + 1) & 1, col + 1, pos + 1 < n);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const int buf = j & 1;
      const E& qx = reinterpret_cast<const E*>(stage_xy[buf][0])[threadIdx.x];
      const E& qy = reinterpret_cast<const E*>(stage_xy[buf][1])[threadIdx.x];
      if constexpr (MIXED) {
        const uint4 z = stage_z[buf][threadIdx.x];
        E qz;
        if ((z.x | z.y | z.z | z.w) == 0)
          bn254::fzero_set(qz);
        else
          bn254::fone(qz);
        acc = bn254::madd_core(acc.x, acc.y, acc.z, qx, qy, qz);
      } else {
        const E& qz = reinterpret_cast<const E*>(stage_z[buf])[threadIdx.x];
        saved[threadIdx.x] = acc;
        acc = bn254::add_core(acc.x, acc.y, acc.z, qx, qy, qz, [&] {
          return bn254::pt_again(saved[threadIdx.x]);
        });
      }
      if (pos < n && (pos + 1 == n || tile_dig[threadIdx.x][col] !=
                                          tile_dig[threadIdx.x][col + 1])) {
        const long long slot = w * nb + tile_dig[threadIdx.x][col];
        bn254::store_pt(sx, sy, sz, slot, acc);
        chunk[slot] = k;
        valid[slot] = 1;
      }
    }
  }
  if (active) bn254::store_pt(tx, ty, tz, k * nwin + w, acc);
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

template <class E, bool MIXED>
int launch_bucket_scan(const void* px, const void* py, const void* pz,
                       const void* order, const void* dsorted, void* sx,
                       void* sy, void* sz, void* chunk, void* valid,
                       void* tx, void* ty, void* tz, int nwin, long long n,
                       int c, int nb, cudaStream_t s) {
  const long long b = (n + c - 1) / c;
  const unsigned blocks =
      (unsigned)((nwin * b + kBucketThreads - 1) / kBucketThreads);
  bucket_scan_kernel<E, MIXED><<<blocks, kBucketThreads, 0, s>>>(
      in(px), in(py), in(pz), static_cast<const long long*>(order),
      static_cast<const long long*>(dsorted), out(sx), out(sy), out(sz),
      static_cast<long long*>(chunk), static_cast<uint8_t*>(valid), out(tx),
      out(ty), out(tz), nwin, n, c, b, nb);
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
  long long lanes = b * r;
  if (lanes <= 0) return 0;
  if (lanes * c >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks = (unsigned)((lanes + kScanThreads - 1) / kScanThreads);
  if (g2)
    scan_kernel<Fe2><<<blocks, kScanThreads, 0, s>>>(
        in(px), in(py), in(pz), out(tx), out(ty), out(tz), out(wx), out(wy),
        out(wz), lanes, c, r, collect);
  else
    scan_kernel<Fe><<<blocks, kScanThreads, 0, s>>>(
        in(px), in(py), in(pz), out(tx), out(ty), out(tz), out(wx), out(wy),
        out(wz), lanes, c, r, collect);
  return (int)cudaGetLastError();
}

// The bucket scan of nwin windows over an (n,) point table (see the
// layout notes at the top): slots (nwin, nb) points, chunk (nwin, nb)
// int64 and valid (nwin, nb) bytes, filled by the caller with infinity,
// 0 and 0; totals (ceil(n / c), nwin).  mixed: the table is affine or
// infinity and the combine is the mixed add.
extern "C" int zk_point_bucket_scan(int g2, int mixed, const void* px,
                                    const void* py, const void* pz,
                                    const void* order, const void* dsorted,
                                    void* sx, void* sy, void* sz,
                                    void* chunk, void* valid, void* tx,
                                    void* ty, void* tz, int nwin,
                                    long long n, int c, int nb,
                                    void* stream) {
  if (nwin <= 0 || n <= 0) return 0;
  if (c <= 0 || n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto go = [&](auto launch) {
    return launch(px, py, pz, order, dsorted, sx, sy, sz, chunk, valid, tx,
                  ty, tz, nwin, n, c, nb, s);
  };
  if (g2)
    return mixed ? go(launch_bucket_scan<Fe2, true>)
                 : go(launch_bucket_scan<Fe2, false>);
  return mixed ? go(launch_bucket_scan<Fe, true>)
               : go(launch_bucket_scan<Fe, false>);
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
