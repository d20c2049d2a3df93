// Shared-memory negacyclic NTT of one row, and the 32-bit modular
// arithmetic under it, for Hopper (sm_90a). Included by ntt.cu (the NTT
// kernels, on the radix-2 body ntt_fwd_smem / ntt_inv_smem) and ks.cu
// (the fused key-switch kernels, on the register-radix body ntt_fwd_row /
// ntt_inv_row below). Both bodies run the Harvey merged-psi schedule of
// the host tables (eva_tpu_torch/backend/tables.py _fwd_merged /
// _inv_merged) and give the same residues. Forward
// takes natural order in and gives bit-reversed order out; the inverse
// takes bit-reversed in, gives natural out, and folds N^-1 into its last
// stage. Every output is the canonical residue.
//
// Tables are [n_sub, N] uint32 Shoup pairs (w, w') per prime: stage m
// reads entries [m, 2m). A row of 2^logn residues (< q < 2^31) sits in
// shared memory as 32-bit words.

#pragma once

#include <cstdint>

namespace eva {

constexpr int kMaxLogN = 15;  // N = 32768: 128 KB of shared memory
constexpr int kMinLogN = 10;  // N = 1024

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t wp, uint32_t q) {
  // qhat = floor(a * wp / 2^32) underestimates floor(a*w/q) by < 2, so
  // r = a*w - qhat*q lies in [0, 2q) and is exact in wrapping 32-bit math.
  uint32_t qhat = __umulhi(a, wp);
  uint32_t r = a * w - qhat * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  uint32_t s = a + b;  // < 2q < 2^32
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// Forward NTT in place on s[0, 2^logn). Every thread of the block calls
// it after the row is in s and a __syncthreads(); it returns after a
// final __syncthreads(), with the row transformed.
__device__ __forceinline__ void ntt_fwd_smem(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, int logn) {
  const int n = 1 << logn;
  const int half = n >> 1;
  // Stage m (1, 2, ..., N/2): m blocks of 2t elements, t = N / (2m).
  int logt = logn - 1;
  for (int m = 1; m < n; m <<= 1, --logt) {
    const int t = 1 << logt;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int k = j >> logt;
      const int i0 = (k << (logt + 1)) + (j & (t - 1));
      const int i1 = i0 + t;
      const uint32_t lo = s[i0];
      const uint32_t hi = shoup_mul(s[i1], wr[m + k], wpr[m + k], q);
      s[i0] = add_mod(lo, hi, q);
      s[i1] = sub_mod(lo, hi, q);
    }
    __syncthreads();
  }
}

// Inverse NTT in place, N^-1 (Shoup pair nv, nvp) folded into the last
// stage; same calling convention as ntt_fwd_smem.
__device__ __forceinline__ void ntt_inv_smem(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, uint32_t nv,
                                             uint32_t nvp, int logn) {
  const int n = 1 << logn;
  const int half = n >> 1;
  // Stage m (N/2, ..., 2, 1): m blocks of 2t elements, t = N / (2m).
  int logt = 0;
  for (int m = half; m >= 1; m >>= 1, ++logt) {
    const int t = 1 << logt;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int k = j >> logt;
      const int i0 = (k << (logt + 1)) + (j & (t - 1));
      const int i1 = i0 + t;
      const uint32_t lo = s[i0];
      const uint32_t hi = s[i1];
      uint32_t sum = add_mod(lo, hi, q);
      if (m == 1) sum = shoup_mul(sum, nv, nvp, q);  // N^-1, lo branch
      s[i0] = sum;
      s[i1] = shoup_mul(sub_mod(lo, hi, q), wr[m + k], wpr[m + k], q);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The register-radix row body (the key-switch kernels of ks.cu).
//
// Same transforms, tables and outputs as ntt_fwd_smem / ntt_inv_smem, but
// kPassLog stages per pass: each thread loads a group of 2^kPassLog
// elements from shared memory into registers, runs the pass's butterflies
// there, and stores the group back, so a row of 2^14 takes 5 passes and 5
// barriers instead of 14. A forward pass starting at stage s0 with RP
// stages takes groups of stride t = N >> (s0 + RP): element u of group g
// sits at (g / t) * (t << RP) + g % t + u * t, and its stage-(s0 + r)
// butterfly blocks read twiddles (1 << (s0 + r)) + (g / t) * 2^r + block.
// The inverse runs the stages in the opposite order with stride 2^s0.
// Stage 0's twiddle is one word for every thread (a broadcast load); later
// passes read per-group twiddles through the read-only cache.
//
// The row sits in shared memory in a swizzled order: element i at word
// swz(i), which permutes the 32 words of each 32-word line. Groups of a
// small stride (the late forward and early inverse passes) would otherwise
// put up to 8 threads of a warp on one bank; with this swizzle no access
// of the passes at N = 16384 conflicts (1.2-way on average at N = 32768),
// and a warp reading 32 consecutive elements still touches 32 banks.
// Callers write and read the row through swz().

// The passes' modular arithmetic: the same canonical residues as shoup_mul,
// add_mod and sub_mod, each reduction an unsigned min (an in-range value
// is below its wrapped alternative), which compiles to fewer instructions
// than compare and select.
__device__ __forceinline__ uint32_t shoup_mul_r(uint32_t a, uint32_t w,
                                                uint32_t wp, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, wp) * q;  // in [0, 2q)
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

template <int RP>
__device__ __forceinline__ void ntt_fwd_pass(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, int logn, int s0) {
  constexpr int G = 1 << RP;
  const int lt = logn - s0 - RP;  // log2 of the group's stride
  const int groups = 1 << (logn - RP);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int outer = g >> lt;
    const int base = (outer << (lt + RP)) + (g & ((1 << lt) - 1));
    uint32_t v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = s[swz(base + (u << lt))];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int h = G >> (r + 1);  // pair distance within the group
      const int k0 = (1 << (s0 + r)) + (outer << r);
#pragma unroll
      for (int kb = 0; kb < (1 << r); ++kb) {
        const uint32_t w = __ldg(wr + k0 + kb), wp = __ldg(wpr + k0 + kb);
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const int u = kb * 2 * h + j;
          const uint32_t lo = v[u];
          const uint32_t hi = shoup_mul_r(v[u + h], w, wp, q);
          v[u] = add_mod_r(lo, hi, q);
          v[u + h] = sub_mod_r(lo, hi, q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) s[swz(base + (u << lt))] = v[u];
  }
  __syncthreads();
}

template <int RP>
__device__ __forceinline__ void ntt_inv_pass(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, uint32_t nv,
                                             uint32_t nvp, int logn, int s0) {
  constexpr int G = 1 << RP;
  const int lt = s0;
  const int groups = 1 << (logn - RP);
  const bool last = s0 + RP == logn;  // holds the final stage (m == 1)
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int outer = g >> lt;
    const int base = (outer << (lt + RP)) + (g & ((1 << lt) - 1));
    uint32_t v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = s[swz(base + (u << lt))];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int h = 1 << r;
      const int k0 = (1 << (logn - s0 - r - 1)) + (outer << (RP - r - 1));
#pragma unroll
      for (int kb = 0; kb < (G >> (r + 1)); ++kb) {
        const uint32_t w = __ldg(wr + k0 + kb), wp = __ldg(wpr + k0 + kb);
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const int u = kb * 2 * h + j;
          const uint32_t lo = v[u];
          const uint32_t hi = v[u + h];
          uint32_t sum = add_mod_r(lo, hi, q);
          if (last && r == RP - 1) sum = shoup_mul_r(sum, nv, nvp, q);
          v[u] = sum;
          v[u + h] = shoup_mul_r(sub_mod_r(lo, hi, q), w, wp, q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) s[swz(base + (u << lt))] = v[u];
  }
  __syncthreads();
}

// Forward NTT of the swizzled row s; same calling convention and values
// as ntt_fwd_smem.
__device__ __forceinline__ void ntt_fwd_row(uint32_t* s,
                                            const uint32_t* __restrict__ wr,
                                            const uint32_t* __restrict__ wpr,
                                            uint32_t q, int logn) {
  int s0 = 0;
  for (; s0 + kPassLog <= logn; s0 += kPassLog)
    ntt_fwd_pass<kPassLog>(s, wr, wpr, q, logn, s0);
  if (logn - s0 == 2) ntt_fwd_pass<2>(s, wr, wpr, q, logn, s0);
  if (logn - s0 == 1) ntt_fwd_pass<1>(s, wr, wpr, q, logn, s0);
}

// Inverse NTT of the swizzled row s; same values as ntt_inv_smem. The
// short pass comes last, so the final stage's N^-1 fold is in it.
__device__ __forceinline__ void ntt_inv_row(uint32_t* s,
                                            const uint32_t* __restrict__ wr,
                                            const uint32_t* __restrict__ wpr,
                                            uint32_t q, uint32_t nv,
                                            uint32_t nvp, int logn) {
  int s0 = 0;
  for (; s0 + kPassLog <= logn; s0 += kPassLog)
    ntt_inv_pass<kPassLog>(s, wr, wpr, q, nv, nvp, logn, s0);
  if (logn - s0 == 2) ntt_inv_pass<2>(s, wr, wpr, q, nv, nvp, logn, s0);
  if (logn - s0 == 1) ntt_inv_pass<1>(s, wr, wpr, q, nv, nvp, logn, s0);
}

// Threads per block of the register-radix body: two groups of 2^kPassLog
// words per thread at N = 16384, one at N <= 8192; 0 when logn is out of
// range.
inline int row_threads(int logn) {
  if (logn < kMinLogN || logn > kMaxLogN) return 0;
  const int t = 1 << (logn - kPassLog);
  return t < 1024 ? t : 1024;
}

// Threads per block for a row of 2^logn, or 0 when logn is out of range.
inline int block_threads(int logn) {
  if (logn < kMinLogN || logn > kMaxLogN) return 0;
  const int half = 1 << (logn - 1);
  return half < 1024 ? half : 1024;
}

// Dynamic shared memory of one row at the largest ring (128 KB), above
// the 48 KB default: each kernel is opted in once per device.
constexpr int kRowSmemMax = (1 << kMaxLogN) * (int)sizeof(uint32_t);

}  // namespace eva
