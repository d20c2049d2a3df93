// The register-radix negacyclic NTT, and the 32-bit modular arithmetic
// under it, for Hopper (sm_90a). Included by ntt.cu (the NTT kernels, a
// row split over a thread-block cluster) and ks.cu (the fused key-switch
// kernels, a whole row in one block: ntt_fwd_row / ntt_inv_row). Both run
// the Harvey merged-psi schedule of the host tables
// (eva_tpu_torch/backend/tables.py _fwd_merged / _inv_merged) and give the
// same residues. Forward takes natural order in and gives bit-reversed
// order out; the inverse takes bit-reversed in, gives natural out, and
// folds N^-1 into its last stage. Every output is the canonical residue.
//
// Tables are [n_sub, N] uint32 Shoup pairs (w, w') per prime: stage m
// (m = 2^s, s = 0 .. logn - 1) reads entries [m, 2m). Residues are below
// q < 2^31 and computed on as 32-bit words.
//
// kPassLog stages run per pass: each thread holds a group of 2^kPassLog
// elements in registers, runs the pass's butterflies there (fwd_group /
// inv_group), and stores the group back, so a row of 2^14 takes 5 passes
// and 5 barriers instead of 14. A forward pass starting at stage s0 with
// RP stages takes groups of stride t = N >> (s0 + RP): element u of group
// g sits at (g / t) * (t << RP) + g % t + u * t, and its stage-(s0 + r)
// butterfly blocks read twiddles (1 << (s0 + r)) + (g / t) * 2^r + block.
// The inverse runs the stages in the opposite order with stride 2^s0.
// Stage 0's twiddle is one word for every thread (a broadcast load); later
// passes read per-group twiddles through the read-only cache.
//
// A pass may also run on one segment of a row: the L = N / C elements
// [b L, (b + 1) L) of segment b of C. Its stages past the first log2 C
// pair elements of that segment only, and its butterfly blocks are those
// of a row of L with the leading 1 of every twiddle index replaced by
// top = C + b: stage s' of the segment is stage s' + log2 C of the row,
// whose block k reads entry (C << s') + (b << s') + k. (top = 1 is the
// whole row.)
//
// The row sits in shared memory in a swizzled order: element i at word
// swz(i), which permutes the 32 words of each 32-word line. Groups of a
// small stride (the late forward and early inverse passes) would otherwise
// put up to 8 threads of a warp on one bank; with this swizzle only a
// pass of 3 stages at stride 8 or 16 (and one of 2 at stride 2 or 4) puts
// two threads of a warp on one bank, and a warp reading 32 consecutive
// elements still touches 32 banks. Callers write and read the row through
// swz().

#pragma once

#include <cstdint>

namespace eva {

constexpr int kMaxLogN = 15;  // N = 32768: 128 KB of shared memory
constexpr int kMinLogN = 10;  // N = 1024

// The modular arithmetic, each reduction an unsigned min (an in-range
// value is below its wrapped alternative), which compiles to fewer
// instructions than compare and select. Every result is canonical.
__device__ __forceinline__ uint32_t shoup_mul_r(uint32_t a, uint32_t w,
                                                uint32_t wp, uint32_t q) {
  // qhat = floor(a * wp / 2^32) underestimates floor(a*w/q) by < 2, so
  // r = a*w - qhat*q lies in [0, 2q) and is exact in wrapping 32-bit math.
  const uint32_t r = a * w - __umulhi(a, wp) * q;
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t add_mod_r(uint32_t a, uint32_t b,
                                              uint32_t q) {
  const uint32_t s = a + b;  // < 2q < 2^32
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t sub_mod_r(uint32_t a, uint32_t b,
                                              uint32_t q) {
  const uint32_t d = a - b;  // a < b wraps d above 2^31 > q
  return min(d, d + q);
}

constexpr int kPassLog = 3;  // stages per pass: 8 words per group

__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 5) * 9) & 31);
}

// Forward butterflies of one group of 2^RP registers: RP consecutive
// stages, the group's stage-r butterfly blocks reading twiddle entries
// (kb << r) + block.
template <int RP>
__device__ __forceinline__ void fwd_group(uint32_t (&v)[1 << RP],
                                          const uint32_t* __restrict__ wr,
                                          const uint32_t* __restrict__ wpr,
                                          uint32_t q, int kb) {
  constexpr int G = 1 << RP;
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int h = G >> (r + 1);  // pair distance within the group
    const int k0 = kb << r;
#pragma unroll
    for (int blk = 0; blk < (1 << r); ++blk) {
      const uint32_t w = __ldg(wr + k0 + blk), wp = __ldg(wpr + k0 + blk);
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const int u = blk * 2 * h + j;
        const uint32_t lo = v[u];
        const uint32_t hi = shoup_mul_r(v[u + h], w, wp, q);
        v[u] = add_mod_r(lo, hi, q);
        v[u + h] = sub_mod_r(lo, hi, q);
      }
    }
  }
}

// Inverse butterflies of one group of 2^RP registers: RP consecutive
// stages, the group's stage-r butterfly blocks reading twiddle entries
// (kb << (RP - r - 1)) + block. With fold, the last stage is the
// transform's final one (m = 1) and takes N^-1 (Shoup pair nv, nvp) into
// its lo branch.
template <int RP>
__device__ __forceinline__ void inv_group(uint32_t (&v)[1 << RP],
                                          const uint32_t* __restrict__ wr,
                                          const uint32_t* __restrict__ wpr,
                                          uint32_t q, int kb, bool fold,
                                          uint32_t nv, uint32_t nvp) {
  constexpr int G = 1 << RP;
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int h = 1 << r;
    const int k0 = kb << (RP - r - 1);
#pragma unroll
    for (int blk = 0; blk < (G >> (r + 1)); ++blk) {
      const uint32_t w = __ldg(wr + k0 + blk), wp = __ldg(wpr + k0 + blk);
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const int u = blk * 2 * h + j;
        const uint32_t lo = v[u];
        const uint32_t hi = v[u + h];
        uint32_t sum = add_mod_r(lo, hi, q);
        if (fold && r == RP - 1) sum = shoup_mul_r(sum, nv, nvp, q);
        v[u] = sum;
        v[u + h] = shoup_mul_r(sub_mod_r(lo, hi, q), w, wp, q);
      }
    }
  }
}

// One forward pass in place on the swizzled shared row (or segment) s of
// 2^logn elements: stages s0 .. s0 + RP - 1, twiddle indices led by top
// (1 for a whole row). Every thread of the block calls it; it returns
// after a __syncthreads().
template <int RP>
__device__ __forceinline__ void ntt_fwd_pass(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, int logn, int s0,
                                             int top) {
  constexpr int G = 1 << RP;
  const int lt = logn - s0 - RP;  // log2 of the group's stride
  const int groups = 1 << (logn - RP);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int outer = g >> lt;
    const int base = (outer << (lt + RP)) + (g & ((1 << lt) - 1));
    uint32_t v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = s[swz(base + (u << lt))];
    fwd_group<RP>(v, wr, wpr, q, (top << s0) + outer);
#pragma unroll
    for (int u = 0; u < G; ++u) s[swz(base + (u << lt))] = v[u];
  }
  __syncthreads();
}

// One inverse pass, as ntt_fwd_pass; fold when the pass holds the
// transform's final stage.
template <int RP>
__device__ __forceinline__ void ntt_inv_pass(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, uint32_t nv,
                                             uint32_t nvp, int logn, int s0,
                                             int top, bool fold) {
  constexpr int G = 1 << RP;
  const int lt = s0;
  const int groups = 1 << (logn - RP);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int outer = g >> lt;
    const int base = (outer << (lt + RP)) + (g & ((1 << lt) - 1));
    uint32_t v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = s[swz(base + (u << lt))];
    inv_group<RP>(v, wr, wpr, q, (top << (logn - s0 - RP)) + outer, fold,
                  nv, nvp);
#pragma unroll
    for (int u = 0; u < G; ++u) s[swz(base + (u << lt))] = v[u];
  }
  __syncthreads();
}

// Forward NTT of the whole swizzled row s, in one block. Every thread
// calls it after the row is in s and a __syncthreads(); it returns after
// a final __syncthreads(), with the row transformed.
__device__ __forceinline__ void ntt_fwd_row(uint32_t* s,
                                            const uint32_t* __restrict__ wr,
                                            const uint32_t* __restrict__ wpr,
                                            uint32_t q, int logn) {
  int s0 = 0;
  for (; s0 + kPassLog <= logn; s0 += kPassLog)
    ntt_fwd_pass<kPassLog>(s, wr, wpr, q, logn, s0, 1);
  if (logn - s0 == 2) ntt_fwd_pass<2>(s, wr, wpr, q, logn, s0, 1);
  if (logn - s0 == 1) ntt_fwd_pass<1>(s, wr, wpr, q, logn, s0, 1);
}

// Inverse NTT of the whole swizzled row s, as ntt_fwd_row. The short pass
// comes last, so the final stage's N^-1 fold is in it.
__device__ __forceinline__ void ntt_inv_row(uint32_t* s,
                                            const uint32_t* __restrict__ wr,
                                            const uint32_t* __restrict__ wpr,
                                            uint32_t q, uint32_t nv,
                                            uint32_t nvp, int logn) {
  int s0 = 0;
  for (; s0 + kPassLog <= logn; s0 += kPassLog)
    ntt_inv_pass<kPassLog>(s, wr, wpr, q, nv, nvp, logn, s0, 1,
                           s0 + kPassLog == logn);
  if (logn - s0 == 2)
    ntt_inv_pass<2>(s, wr, wpr, q, nv, nvp, logn, s0, 1, true);
  if (logn - s0 == 1)
    ntt_inv_pass<1>(s, wr, wpr, q, nv, nvp, logn, s0, 1, true);
}

// Threads per block of a whole row in one block: two groups of
// 2^kPassLog words per thread at N = 16384, one at N <= 8192; 0 when logn
// is out of range.
inline int row_threads(int logn) {
  if (logn < kMinLogN || logn > kMaxLogN) return 0;
  const int t = 1 << (logn - kPassLog);
  return t < 1024 ? t : 1024;
}

// Dynamic shared memory of one row at the largest ring (128 KB), above
// the 48 KB default: each kernel is opted in once per device.
constexpr int kRowSmemMax = (1 << kMaxLogN) * (int)sizeof(uint32_t);

}  // namespace eva
