// Negacyclic NTT and inverse NTT over RNS limb planes, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   eva_tpu/backend/pallas_ntt.py     _fwd_kernel, _inv_kernel (PallasNTT)
//   eva_tpu/backend/pallas_ntt_v2.py  _fwd_kernel_v2, _inv_kernel_v2
// All of them compute the same values as the Harvey merged-psi schedule of
// eva_tpu/backend/tables.py (_fwd_merged / _inv_merged), which is what this
// file runs (the stage loops live in ntt_common.cuh, shared with ks.cu):
// forward takes natural order in and gives bit-reversed order out; the
// inverse takes bit-reversed in, gives natural out, and folds N^-1 into
// its last stage. Every output is the canonical residue, so results equal
// the TPU kernels' and the host tables' bit for bit.
//
// Layout: data is [rows, N] int64 (residues < q < 2^31), row r uses prime
// r % n_sub. Twiddle tables are [n_sub, N] uint32 Shoup pairs (w, w'):
// stage m reads entries [m, 2m).
//
// What bounds it on this card: a row of N residues is read once and
// written once (16N bytes as int64) and takes N/2 log2(N) butterflies of
// ~14 32-bit integer operations. At N=16384 that is 256 KB against 1.6M
// operations: ~78 ns at 3.35 TB/s against ~96 ns at the 16.7e12 int32
// op/s of 132 SMs x 64 INT32 lanes, so operations bound it, narrowly.
// The design keeps one block per (batch, row) with the whole row resident
// in shared memory as 32-bit words (N=16384 is 64 KB; N=32768 is 128 KB
// via the dynamic shared-memory opt-in), so device memory sees exactly
// one read and one write per element, and all log2(N) stages run out of
// shared memory with one __syncthreads() between them. What it does not
// do yet: at the main path's shapes there are only B*n_sub rows (22-52
// blocks for 132 SMs), and each block walks its stages serially, so the
// kernel runs far from the bound. Splitting a row over several blocks or
// a cluster, radix-4/8 butterflies in registers, several rows per block
// and 32-bit I/O are the next steps.

#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

using namespace eva;

__global__ void ntt_fwd_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ w,
                               const uint32_t* __restrict__ wp,
                               const uint32_t* __restrict__ qs, int n_sub,
                               int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int p = blockIdx.x % n_sub;
  const size_t base = (size_t)blockIdx.x * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = (uint32_t)in[base + i];
  __syncthreads();
  ntt_fwd_smem(s, w + (size_t)p * n, wp + (size_t)p * n, qs[p], logn);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = (int64_t)s[i];
}

__global__ void ntt_inv_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ w,
                               const uint32_t* __restrict__ wp,
                               const uint32_t* __restrict__ qs,
                               const uint32_t* __restrict__ ninv,
                               const uint32_t* __restrict__ ninvp, int n_sub,
                               int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int p = blockIdx.x % n_sub;
  const size_t base = (size_t)blockIdx.x * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = (uint32_t)in[base + i];
  __syncthreads();
  ntt_inv_smem(s, w + (size_t)p * n, wp + (size_t)p * n, qs[p], ninv[p],
               ninvp[p], logn);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = (int64_t)s[i];
}

}  // namespace

extern "C" {

// Opt both kernels in to the dynamic shared memory the largest ring needs
// (N = 32768: 128 KB, above the 48 KB default) on the current device.
int eva_ntt_init() {
  cudaError_t err = cudaFuncSetAttribute(
      ntt_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRowSmemMax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      ntt_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRowSmemMax);
}

// Forward NTT of `rows` rows of length 2^logn; returns the cudaError_t of
// the launch (0 on success).
int eva_ntt_fwd(const void* in, void* out, const void* w, const void* wp,
                const void* q, int rows, int n_sub, int logn, void* stream) {
  const int threads = block_threads(logn);
  if (threads == 0 || rows <= 0 || n_sub <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << logn;
  ntt_fwd_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)w,
      (const uint32_t*)wp, (const uint32_t*)q, n_sub, logn);
  return (int)cudaGetLastError();
}

// Inverse NTT with N^-1 folded in; same conventions as eva_ntt_fwd.
int eva_ntt_inv(const void* in, void* out, const void* w, const void* wp,
                const void* q, const void* ninv, const void* ninvp, int rows,
                int n_sub, int logn, void* stream) {
  const int threads = block_threads(logn);
  if (threads == 0 || rows <= 0 || n_sub <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << logn;
  ntt_inv_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)w,
      (const uint32_t*)wp, (const uint32_t*)q, (const uint32_t*)ninv,
      (const uint32_t*)ninvp, n_sub, logn);
  return (int)cudaGetLastError();
}

}  // extern "C"
