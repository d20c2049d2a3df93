// Fused hybrid key switch for Hopper (sm_90a): the digit MAC and the
// P-division epilogue.
//
// Replaces the TPU kernels of the JAX package:
//   eva_tpu/backend/pallas_ks.py  _mac_kernel       (PallasKeySwitch.mac)
//   eva_tpu/backend/pallas_ks.py  _epilogue_kernel  (PallasEpilogue.epilogue)
// and computes the same values (every step is exact modular arithmetic;
// the row NTTs are the merged-psi schedule of ntt_common.cuh, shared with
// ntt.cu). Plain PyTorch versions: eva_tpu_torch/backend/ks.py.
//
// Data is int64 in device memory (residues < q < 2^31), 32-bit words in
// shared memory and registers. Row i of the extended basis (the level's
// n_cur data primes, then the n_key key primes) uses prime i and row i of
// the [n_ext, N] twiddle tables.
//
// ks_mac_kernel, grid (n_ext, B), one block per (ext row i, batch b). The
// TPU grid's sequential digit axis j becomes a loop inside the block:
//   1. fast base extension of digit j's row i into shared memory:
//      d = sum_k mont_mul(y[b, j, k], conv[j*alpha + k, i]) mod q_i;
//   2. the forward NTT of that row in shared memory, or, for the digit
//      that owns data row i when x_ntt is given, the x_ntt[b, i] row
//      (the same values: the FBE representative differs from the digit
//      by multiples of the group's primes);
//   3. Montgomery multiplication by the key rows k0[j, i], k1[j, i],
//      streamed from device memory, into two per-thread register
//      accumulators (N / blockDim words each: 16 at N = 16384);
//   4. one write of acc0[b, i] and acc1[b, i].
// What bounds it: at Sobel's level 0 (n_cur 11, n_key 2, alpha 2, six
// digit groups, N = 16384, B = 1) it must read 20.4 MB of key rows and
// 2.9 MB of inputs and write 3.4 MB (8.6 us at 3.35 TB/s), and run 67 row
// NTTs plus the FBE and MAC, ~170M 32-bit integer operations (10.2 us at
// 16.7e12 op/s): operations, narrowly; at B = 4 the keys are shared and
// operations bound it clearly. Its design reads each key row once per
// block and keeps the accumulators out of device memory until the end.
// What it does not do yet: at B = 1 only n_ext = 13 blocks occupy the
// card's 132 SMs, and each walks its digits and NTT stages serially.
//
// The epilogue (ks_epilogue): a Hopper block cannot hold the TPU kernel's
// n_ext resident rows (13 x 64 KB), so it is two launches:
//   ks_key_intt_kernel, one block per (accumulator a, b, key row kk):
//      the inverse NTT of the n_key key rows into a uint32 scratch;
//   ks_epilogue_kernel, one block per (a, b, output row r): the inverse
//      NTT of row r in shared memory, then for each key prime, the last
//      first, the centred divide-and-round of row r, recomputing from the
//      scratch the chain of key-row lifts it needs (pointwise, n_key <=
//      8); with out_ntt the forward NTT of row r; one write.
// What bounds it: at Sobel's level 0 it moves 6.3 MB (1.9 us) and runs
// 48 row NTTs plus the divisions, ~86M operations (5.1 us): operations.
// At B = 1 the row pass has 2 * n_out = 22 blocks for 132 SMs.

#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

using namespace eva;

constexpr int kMaxKey = 8;  // ks.MAX_KEY_PRIMES

// a * b * 2^-32 mod q (b in Montgomery form: b = b' * 2^32 mod q), for any
// a < 2^32 and b < q < 2^31: t + m*q < 2^64, and u = (t + m*q) / 2^32 <
// 2q, so one conditional subtraction gives the canonical residue (the
// value of the JAX package's mont_mul).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t nqinv) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * nqinv;
  const uint32_t u = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return u >= q ? u - q : u;
}

template <int PER>
__global__ void __launch_bounds__(1024)
    ks_mac_kernel(const int64_t* __restrict__ y,      // [B, G, alpha, N]
                  const int64_t* __restrict__ x_ntt,  // [B, n_cur, N] | null
                  const int64_t* __restrict__ k0,     // [G, n_ext, N]
                  const int64_t* __restrict__ k1,     // [G, n_ext, N]
                  const int64_t* __restrict__ conv,   // [G * alpha, n_ext]
                  const int64_t* __restrict__ owner,  // [n_ext]
                  const uint32_t* __restrict__ qs,
                  const uint32_t* __restrict__ nqinvs,
                  const uint32_t* __restrict__ w,     // [n_ext, N]
                  const uint32_t* __restrict__ wp,    // [n_ext, N]
                  int64_t* __restrict__ acc0,         // [B, n_ext, N]
                  int64_t* __restrict__ acc1, int n_groups, int alpha,
                  int n_ext, int n_cur, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int T = blockDim.x;  // == n / PER
  const uint32_t q = qs[i];
  const uint32_t nqinv = nqinvs[i];
  const uint32_t* wr = w + (size_t)i * n;
  const uint32_t* wpr = wp + (size_t)i * n;
  // Block-uniform: the digit whose own row i is read from x_ntt.
  const int own = (x_ntt != nullptr && i < n_cur) ? (int)owner[i] : -1;

  uint32_t a0[PER], a1[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) a0[e] = a1[e] = 0;

  for (int j = 0; j < n_groups; ++j) {
    const int64_t* k0r = k0 + ((size_t)j * n_ext + i) * n;
    const int64_t* k1r = k1 + ((size_t)j * n_ext + i) * n;
    const int64_t* src;  // this digit's NTT row, int64 in device memory
    if (j == own) {
      src = x_ntt + ((size_t)b * n_cur + i) * n;
    } else {
      const int64_t* yr = y + ((size_t)b * n_groups + j) * alpha * n;
      const int64_t* cr = conv + (size_t)j * alpha * n_ext + i;
      for (int e = tid; e < n; e += T) {
        uint32_t d = 0;
        for (int k = 0; k < alpha; ++k)
          d = add_mod(d,
                      mont_mul((uint32_t)yr[(size_t)k * n + e],
                               (uint32_t)cr[(size_t)k * n_ext], q, nqinv),
                      q);
        s[e] = d;
      }
      __syncthreads();
      ntt_fwd_smem(s, wr, wpr, q, logn);
      src = nullptr;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * T;
      const uint32_t v = src ? (uint32_t)src[idx] : s[idx];
      a0[e] = add_mod(a0[e], mont_mul(v, (uint32_t)k0r[idx], q, nqinv), q);
      a1[e] = add_mod(a1[e], mont_mul(v, (uint32_t)k1r[idx], q, nqinv), q);
    }
    // The next digit's FBE overwrites s.
    if (!src) __syncthreads();
  }

  int64_t* o0 = acc0 + ((size_t)b * n_ext + i) * n;
  int64_t* o1 = acc1 + ((size_t)b * n_ext + i) * n;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    o0[tid + e * T] = (int64_t)a0[e];
    o1[tid + e * T] = (int64_t)a1[e];
  }
}

// Block (a, b, kk): inverse NTT of key row kk (ext row n_ext - n_key + kk)
// of accumulator a, batch b, into scratch[a, b, kk] (uint32).
__global__ void ks_key_intt_kernel(const int64_t* __restrict__ acc0,
                                   const int64_t* __restrict__ acc1,
                                   uint32_t* __restrict__ scratch,
                                   const uint32_t* __restrict__ qs,
                                   const uint32_t* __restrict__ wi,
                                   const uint32_t* __restrict__ wpi,
                                   const uint32_t* __restrict__ ninv,
                                   const uint32_t* __restrict__ ninvp,
                                   int batch, int n_ext, int n_key,
                                   int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int kk = blockIdx.x % n_key;
  const int b = (blockIdx.x / n_key) % batch;
  const int a = blockIdx.x / (n_key * batch);
  const int row = n_ext - n_key + kk;
  const int64_t* src = (a ? acc1 : acc0) + ((size_t)b * n_ext + row) * n;

  for (int e = threadIdx.x; e < n; e += blockDim.x) s[e] = (uint32_t)src[e];
  __syncthreads();
  ntt_inv_smem(s, wi + (size_t)row * n, wpi + (size_t)row * n, qs[row],
               ninv[row], ninvp[row], logn);
  uint32_t* dst = scratch + (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = s[e];
}

// Block (a, b, r), r < n_out = n_ext - n_key: row r of d_a[b].
// pdiv is [n_key, 2 * n_ext + 2] int64: for division step d (dropping ext
// prime n_ext - 1 - d), columns [0, n_ext) hold (p_d^-1 mod q_r), columns
// [n_ext, 2 n_ext) its Shoup quotient, then p_d and p_d / 2.
__global__ void ks_epilogue_kernel(const int64_t* __restrict__ acc0,
                                   const int64_t* __restrict__ acc1,
                                   const uint32_t* __restrict__ scratch,
                                   int64_t* __restrict__ out0,
                                   int64_t* __restrict__ out1,
                                   const uint32_t* __restrict__ qs,
                                   const uint32_t* __restrict__ wi,
                                   const uint32_t* __restrict__ wpi,
                                   const uint32_t* __restrict__ ninv,
                                   const uint32_t* __restrict__ ninvp,
                                   const uint32_t* __restrict__ wf,
                                   const uint32_t* __restrict__ wpf,
                                   const int64_t* __restrict__ pdiv,
                                   int batch, int n_ext, int n_key,
                                   int out_ntt, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int n_out = n_ext - n_key;
  const int n_cur = n_out;
  const int r = blockIdx.x % n_out;
  const int b = (blockIdx.x / n_out) % batch;
  const int a = blockIdx.x / (n_out * batch);
  const uint32_t q = qs[r];
  const int pstride = 2 * n_ext + 2;
  const int64_t* src = (a ? acc1 : acc0) + ((size_t)b * n_ext + r) * n;
  const uint32_t* keys = scratch + ((size_t)a * batch + b) * n_key * n;

  for (int e = threadIdx.x; e < n; e += blockDim.x) s[e] = (uint32_t)src[e];
  __syncthreads();
  ntt_inv_smem(s, wi + (size_t)r * n, wpi + (size_t)r * n, q, ninv[r],
               ninvp[r], logn);

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    uint32_t key[kMaxKey];
    for (int kk = 0; kk < n_key; ++kk) key[kk] = keys[(size_t)kk * n + e];
    uint32_t x = s[e];
    for (int d = 0; d < n_key; ++d) {
      const int64_t* pd = pdiv + (size_t)d * pstride;
      const uint32_t p = (uint32_t)pd[2 * n_ext];
      const uint32_t p_half = (uint32_t)pd[2 * n_ext + 1];
      const int last = n_key - 1 - d;   // key row of the dropped prime
      const uint32_t lift = key[last];  // its coefficient, < p
      const uint32_t shift = p - lift;  // x + shift < 2^32
      const uint32_t corr = lift > p_half ? 0u : 1u;
      x = sub_mod(shoup_mul(x + shift, (uint32_t)pd[r],
                            (uint32_t)pd[n_ext + r], q),
                  corr, q);
      for (int kk = 0; kk < last; ++kk) {
        const int row = n_cur + kk;
        const uint32_t qk = qs[row];
        key[kk] = sub_mod(shoup_mul(key[kk] + shift, (uint32_t)pd[row],
                                    (uint32_t)pd[n_ext + row], qk),
                          corr, qk);
      }
    }
    s[e] = x;
  }
  __syncthreads();
  if (out_ntt)
    ntt_fwd_smem(s, wf + (size_t)r * n, wpf + (size_t)r * n, q, logn);

  int64_t* dst = (a ? out1 : out0) + ((size_t)b * n_out + r) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = (int64_t)s[e];
}

template <int PER>
cudaError_t launch_mac(dim3 grid, int threads, size_t smem,
                       cudaStream_t stream, const int64_t* y,
                       const int64_t* x_ntt, const int64_t* k0,
                       const int64_t* k1, const int64_t* conv,
                       const int64_t* owner, const uint32_t* q,
                       const uint32_t* nqinv, const uint32_t* w,
                       const uint32_t* wp, int64_t* acc0, int64_t* acc1,
                       int n_groups, int alpha, int n_ext, int n_cur,
                       int logn) {
  ks_mac_kernel<PER><<<grid, threads, smem, stream>>>(
      y, x_ntt, k0, k1, conv, owner, q, nqinv, w, wp, acc0, acc1, n_groups,
      alpha, n_ext, n_cur, logn);
  return cudaGetLastError();
}

template <typename K>
cudaError_t opt_in(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmemMax);
}

}  // namespace

extern "C" {

// Opt every kernel in to the dynamic shared memory of one row at the
// largest ring (128 KB) on the current device.
int eva_ks_init() {
  cudaError_t err;
  if ((err = opt_in(ks_mac_kernel<2>)) != cudaSuccess) return (int)err;
  if ((err = opt_in(ks_mac_kernel<4>)) != cudaSuccess) return (int)err;
  if ((err = opt_in(ks_mac_kernel<8>)) != cudaSuccess) return (int)err;
  if ((err = opt_in(ks_mac_kernel<16>)) != cudaSuccess) return (int)err;
  if ((err = opt_in(ks_mac_kernel<32>)) != cudaSuccess) return (int)err;
  if ((err = opt_in(ks_key_intt_kernel)) != cudaSuccess) return (int)err;
  return (int)opt_in(ks_epilogue_kernel);
}

// The MAC for `batch` elements; returns the cudaError_t of the launch.
// x_ntt may be null (no own-row reads).
int eva_ks_mac(const void* y, const void* x_ntt, const void* k0,
               const void* k1, const void* conv, const void* owner,
               const void* q, const void* nqinv, const void* w,
               const void* wp, void* acc0, void* acc1, int batch,
               int n_groups, int alpha, int n_ext, int n_cur, int logn,
               void* stream) {
  const int threads = block_threads(logn);
  if (threads == 0 || batch <= 0 || batch > 65535 || n_groups <= 0 ||
      alpha <= 0 || n_ext <= 0 || n_cur < 0 || n_cur > n_ext)
    return (int)cudaErrorInvalidValue;
  const int per = (1 << logn) / threads;
  const dim3 grid(n_ext, batch);
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t (*launch)(dim3, int, size_t, cudaStream_t, const int64_t*,
                        const int64_t*, const int64_t*, const int64_t*,
                        const int64_t*, const int64_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, const uint32_t*,
                        int64_t*, int64_t*, int, int, int, int, int);
  switch (per) {
    case 2: launch = launch_mac<2>; break;
    case 4: launch = launch_mac<4>; break;
    case 8: launch = launch_mac<8>; break;
    case 16: launch = launch_mac<16>; break;
    case 32: launch = launch_mac<32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)launch(grid, threads, smem, (cudaStream_t)stream,
                     (const int64_t*)y, (const int64_t*)x_ntt,
                     (const int64_t*)k0, (const int64_t*)k1,
                     (const int64_t*)conv, (const int64_t*)owner,
                     (const uint32_t*)q, (const uint32_t*)nqinv,
                     (const uint32_t*)w, (const uint32_t*)wp,
                     (int64_t*)acc0, (int64_t*)acc1, n_groups, alpha, n_ext,
                     n_cur, logn);
}

// The epilogue for `batch` elements: the key-row inverse NTTs into
// `scratch` ([2, batch, n_key, N] uint32), then the row pass into out0 /
// out1 ([batch, n_ext - n_key, N] int64). Returns the first launch's
// error, if any.
int eva_ks_epilogue(const void* acc0, const void* acc1, void* scratch,
                    void* out0, void* out1, const void* q, const void* wi,
                    const void* wpi, const void* ninv, const void* ninvp,
                    const void* wf, const void* wpf, const void* pdiv,
                    int batch, int n_ext, int n_key, int out_ntt, int logn,
                    void* stream) {
  const int threads = block_threads(logn);
  if (threads == 0 || batch <= 0 || n_key <= 0 || n_key > kMaxKey ||
      n_key >= n_ext)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << logn;
  cudaStream_t st = (cudaStream_t)stream;
  ks_key_intt_kernel<<<2 * batch * n_key, threads, smem, st>>>(
      (const int64_t*)acc0, (const int64_t*)acc1, (uint32_t*)scratch,
      (const uint32_t*)q, (const uint32_t*)wi, (const uint32_t*)wpi,
      (const uint32_t*)ninv, (const uint32_t*)ninvp, batch, n_ext, n_key,
      logn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ks_epilogue_kernel<<<2 * batch * (n_ext - n_key), threads, smem, st>>>(
      (const int64_t*)acc0, (const int64_t*)acc1, (const uint32_t*)scratch,
      (int64_t*)out0, (int64_t*)out1, (const uint32_t*)q,
      (const uint32_t*)wi, (const uint32_t*)wpi, (const uint32_t*)ninv,
      (const uint32_t*)ninvp, (const uint32_t*)wf, (const uint32_t*)wpf,
      (const int64_t*)pdiv, batch, n_ext, n_key, out_ntt, logn);
  return (int)cudaGetLastError();
}

}  // extern "C"
