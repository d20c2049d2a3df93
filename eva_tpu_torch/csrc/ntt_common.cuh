// Shared-memory negacyclic NTT of one row, and the 32-bit modular
// arithmetic under it, for Hopper (sm_90a). Included by ntt.cu (the NTT
// kernels) and ks.cu (the fused key-switch kernels), so both run one NTT
// body: the Harvey merged-psi radix-2 schedule of the host tables
// (eva_tpu_torch/backend/tables.py _fwd_merged / _inv_merged). Forward
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
