// Fused hybrid key switch for Hopper (sm_90a): the digit MAC and the
// P-division epilogue.
//
// Replaces the TPU kernels of the JAX package:
//   eva_tpu/backend/pallas_ks.py  _mac_kernel       (PallasKeySwitch.mac)
//   eva_tpu/backend/pallas_ks.py  _epilogue_kernel  (PallasEpilogue.epilogue)
// and computes the same values (every step is exact modular arithmetic;
// the row NTTs are the merged-psi schedule of ntt_common.cuh, on its
// register-radix body ntt_fwd_row / ntt_inv_row). Plain PyTorch versions:
// eva_tpu_torch/backend/ks.py.
//
// Data is uint32 words throughout (int32 tensors carrying the residues'
// uint32 bits; residues < q < 2^31): in device memory, in shared memory
// (in the swizzled order of ntt_common.cuh) and in registers. Only the
// digit-owner table is int64 (an index).
// Row i of the extended basis (the level's n_cur data primes, then the
// n_key key primes) uses prime i and row i of the [n_ext, N] twiddle
// tables. Blocks have row_threads(logn) threads: 1024 from N = 8192 up.
//
// ks_mac_cluster_kernel: grid (n_ext * C, B), one block per (ext row i,
// digit slice c, batch b); the C blocks of one (i, b) form a thread-block
// cluster along the digit axis (cudaLaunchKernelEx with a cluster
// dimension). Block c walks the digits j = c, c + C, ...; per digit:
//   1. one warp asks for both key rows k0[j, i], k1[j, i] to be brought
//      into L2 with bulk asynchronous prefetches (cp.async.bulk.prefetch;
//      2 x 128 KB at N = 16384 fit no block's shared memory beside the
//      row), so they arrive while steps 2-3 compute;
//   2. fast base extension of digit j's row i into shared memory:
//      d = sum_k mont_mul(y[b, j, k], conv[j*alpha + k, i]) mod q_i;
//   3. the forward NTT of that row, or, for the digit that owns data row i
//      when x_ntt is given, the x_ntt[b, i] row (the same values: the FBE
//      representative differs from the digit by multiples of the group's
//      primes); that block skips the NTT, so the cluster is unbalanced by
//      one row's FBE + NTT, which is accepted;
//   4. Montgomery multiplication by the two key rows into per-thread
//      register accumulators (N / 1024 words each: 16 at N = 16384).
// Then the C partial sums meet in distributed shared memory: each block
// puts its partial acc0 into its shared row, the cluster synchronises,
// and block c adds its 1/C slice of the columns over the C ranks
// (map_shared_rank) and writes that slice of acc0 once; then acc1 the
// same way. add_mod of canonical residues is exact, associative and
// commutative, so the sum over ranks in any order is the plain version's
// residue, bit for bit.
// The cluster size C <= min(n_groups, 8) is the one that takes the fewest
// rounds of digits, given how many clusters of C the card holds at once
// (cudaOccupancyMaxActiveClusters; see mac_cluster_size): at Sobel's level
// 0 (six digit groups) C = 6 at B = 1, one digit per block; C = 2 at B = 4,
// three digits per block in one wave rather than four waves of one.
// What bounds it: at Sobel's level 0 (n_cur 11, n_key 2, alpha 2, six
// digit groups, N = 16384, B = 1) it must read 10.2 MB of key rows and
// 1.4 MB of inputs and write 1.7 MB (4.0 us at 3.35 TB/s), and run 67 row
// NTTs plus the FBE and MAC, ~170M 32-bit integer operations (10.2 us at
// 16.7e12 op/s): operations, clearly. The
// design spreads the 67 NTTs over 78 blocks (one SM each) instead of 13,
// and runs each NTT in 5 register passes instead of 14 shared-memory
// stages.
//
// The epilogue (ks_epilogue): a Hopper block cannot hold the TPU kernel's
// n_ext resident rows (13 x 64 KB), so it is two launches, overlapped by
// programmatic dependent launch. (A cluster per group of output rows, its
// first n_key blocks transforming the key rows for the others, would
// repeat the key rows' inverse NTTs in every cluster and needs n_key + 1
// <= 8 blocks, where the kernels take n_key up to 8.)
//   ks_epilogue_key_kernel, one block per (accumulator a, b, key row kk):
//      lets its dependent grid launch at once, then the inverse NTT of key
//      row kk into a uint32 scratch;
//   ks_epilogue_row_kernel<n_key>, one block per (a, b, output row r),
//      launched with programmatic stream serialization, so it runs beside
//      the key kernel: the inverse NTT of row r in shared memory; then it
//      waits for the key kernel's grid (griddepcontrol.wait) and, for each
//      key prime, the last first, runs the centred divide-and-round of row
//      r, recomputing from the scratch the chain of key-row lifts it needs
//      (pointwise, in registers); with out_ntt the forward NTT of row r;
//      one write.
// The critical path is two row transforms (iNTT, then NTT) instead of
// three. What bounds it: at Sobel's level 0 it moves 3.1 MB (0.9 us) and
// runs 48 row NTTs plus the divisions, ~86M operations (5.1 us):
// operations.
//
// Resources on the H100 (chip_smoke.py prints them, from eva_ks_info;
// nvcc -Xptxas -v at build): 1024 threads per block from N = 8192 up, so
// a thread may hold 64 registers and each SM holds one block of every
// kernel. The MAC kernel uses all 64 and spills 48 bytes per thread at
// N = 16384 (208 at N = 32768: its 2 x 32 accumulators); the key kernel
// uses 46 registers, the row kernel 54 (n_key = 2), neither spills. A
// cluster of 8 MAC blocks fits the card 15 times at once, of 6 17 times.
// Left on the table: a row's NTT still runs on one SM, at about that SM's
// 32-bit integer rate (~13 us at N = 16384), and at B = 1 both kernels
// leave SMs idle (78 and 26 blocks for 132 SMs); splitting a row over a
// cluster would use them. The bulk L2 prefetch of the key rows moves
// little: it costs 2% at B = 1 and saves 2% at B = 4 (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace eva;

constexpr int kMaxKey = 8;      // ks.MAX_KEY_PRIMES
constexpr int kMaxCluster = 8;  // the portable thread-block cluster size

// a * b * 2^-32 mod q (b in Montgomery form: b = b' * 2^32 mod q), for any
// a < 2^32 and b < q < 2^31: t + m*q < 2^64, and u = (t + m*q) / 2^32 <
// 2q, so one conditional subtraction (an unsigned min) gives the
// canonical residue (the value of the JAX package's mont_mul).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t nqinv) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * nqinv;
  const uint32_t u = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return min(u, u - q);
}

// Asks for `bytes` (a multiple of 16) at the 16-byte aligned p to be
// brought into L2, asynchronously.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// Rows move from device memory into the swizzled shared row in batches of
// kBatch elements per thread, so each thread has kBatch loads in flight (N
// is a multiple of kBatch * blockDim.x).
constexpr int kBatch = 8;

__device__ __forceinline__ void load_row(uint32_t* s,
                                         const uint32_t* __restrict__ src,
                                         int n) {
  const int T = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * T) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = src[e0 + u * T];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s[swz(e0 + u * T)] = v[u];
  }
}

// One accumulator's cluster sum: part (this block's partial, element
// threadIdx.x + e * blockDim.x in part[e]) goes into the shared row s;
// after the cluster barrier, out[lo, hi) gets the sum over all ranks.
template <int PER>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            uint32_t* s,
                                            const uint32_t (&part)[PER],
                                            uint32_t* __restrict__ out,
                                            int C, int lo, int hi,
                                            uint32_t q) {
#pragma unroll
  for (int e = 0; e < PER; ++e)
    s[swz(threadIdx.x + e * blockDim.x)] = part[e];
  cluster.sync();
  for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    const int at = swz(e);
    uint32_t sum = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) sum = add_mod_r(sum, cluster.map_shared_rank(s, r)[at], q);
    out[e] = sum;
  }
  // No rank writes s again, or exits, before every rank has read it.
  cluster.sync();
}

template <int PER>
__global__ void __launch_bounds__(1024, 1)
    ks_mac_cluster_kernel(
        const uint32_t* __restrict__ y,      // [B, G, alpha, N]
        const uint32_t* __restrict__ x_ntt,  // [B, n_cur, N] | null
        const uint32_t* __restrict__ k0,     // [G, n_ext, N]
        const uint32_t* __restrict__ k1,     // [G, n_ext, N]
        const uint32_t* __restrict__ conv,   // [G * alpha, n_ext]
        const int64_t* __restrict__ owner,   // [n_ext]
        const uint32_t* __restrict__ qs, const uint32_t* __restrict__ nqinvs,
        const uint32_t* __restrict__ w,   // [n_ext, N]
        const uint32_t* __restrict__ wp,  // [n_ext, N]
        uint32_t* __restrict__ acc0,      // [B, n_ext, N]
        uint32_t* __restrict__ acc1, int n_groups, int alpha, int n_ext,
        int n_cur, int logn) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int n = 1 << logn;
  const int i = blockIdx.x / C;
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

  for (int j = c; j < n_groups; j += C) {
    const uint32_t* k0r = k0 + ((size_t)j * n_ext + i) * n;
    const uint32_t* k1r = k1 + ((size_t)j * n_ext + i) * n;
    if (tid < 32) {  // a row is 4N bytes: 32 chunks of N / 8
      const uint32_t chunk = (uint32_t)n * 4 / 32;
      prefetch_l2((const char*)k0r + tid * chunk, chunk);
      prefetch_l2((const char*)k1r + tid * chunk, chunk);
    }
    const uint32_t* src;  // this digit's NTT row, in device memory
    if (j == own) {
      src = x_ntt + ((size_t)b * n_cur + i) * n;
    } else {
      const uint32_t* yr = y + ((size_t)b * n_groups + j) * alpha * n;
      const uint32_t* cr = conv + (size_t)j * alpha * n_ext + i;
      for (int e0 = tid; e0 < n; e0 += kBatch * T) {
        uint32_t d[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) d[u] = 0;
        for (int k = 0; k < alpha; ++k) {
          const uint32_t* yk = yr + (size_t)k * n + e0;
          const uint32_t ck = cr[(size_t)k * n_ext];
          uint32_t v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) v[u] = yk[u * T];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            d[u] = add_mod_r(d[u], mont_mul(v[u], ck, q, nqinv), q);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) s[swz(e0 + u * T)] = d[u];
      }
      __syncthreads();
      ntt_fwd_row(s, wr, wpr, q, logn);
      src = nullptr;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * T;
      const uint32_t v = src ? src[idx] : s[swz(idx)];
      a0[e] = add_mod_r(a0[e], mont_mul(v, k0r[idx], q, nqinv), q);
      a1[e] = add_mod_r(a1[e], mont_mul(v, k1r[idx], q, nqinv), q);
    }
    // The next digit's FBE, or the cluster sum, overwrites s.
    if (!src) __syncthreads();
  }

  // Block c writes columns [lo, hi) of both accumulators: a 1/C slice,
  // rounded up to whole 32-word lines.
  const int chunk = ((n + C - 1) / C + 31) & ~31;
  const int lo = min(n, c * chunk);
  const int hi = min(n, lo + chunk);
  const size_t row = ((size_t)b * n_ext + i) * n;
  cluster_sum<PER>(cluster, s, a0, acc0 + row, C, lo, hi, q);
  cluster_sum<PER>(cluster, s, a1, acc1 + row, C, lo, hi, q);
}

// Block (a, b, kk): inverse NTT of key row kk (ext row n_ext - n_key + kk)
// of accumulator a, batch b, into scratch[a, b, kk] (uint32).
__global__ void __launch_bounds__(1024)
    ks_epilogue_key_kernel(const uint32_t* __restrict__ acc0,
                           const uint32_t* __restrict__ acc1,
                           uint32_t* __restrict__ scratch,
                           const uint32_t* __restrict__ qs,
                           const uint32_t* __restrict__ wi,
                           const uint32_t* __restrict__ wpi,
                           const uint32_t* __restrict__ ninv,
                           const uint32_t* __restrict__ ninvp, int batch,
                           int n_ext, int n_key, int logn) {
  // The row kernel may start now: it waits for this grid's completion
  // (and the visibility of its scratch) before it reads the scratch.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int kk = blockIdx.x % n_key;
  const int b = (blockIdx.x / n_key) % batch;
  const int a = blockIdx.x / (n_key * batch);
  const int row = n_ext - n_key + kk;
  const uint32_t* src = (a ? acc1 : acc0) + ((size_t)b * n_ext + row) * n;

  load_row(s, src, n);
  __syncthreads();
  ntt_inv_row(s, wi + (size_t)row * n, wpi + (size_t)row * n, qs[row],
              ninv[row], ninvp[row], logn);
  uint32_t* dst = scratch + (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = s[swz(e)];
}

// Block (a, b, r), r < n_out = n_ext - n_key: row r of d_a[b], for
// n_key = NKEY (one kernel per key-prime count, so the division's key
// values and loops live in registers).
// pdiv is [n_key, 2 * n_ext + 2] uint32: for division step d (dropping ext
// prime n_ext - 1 - d), columns [0, n_ext) hold (p_d^-1 mod q_r), columns
// [n_ext, 2 n_ext) its Shoup quotient, then p_d and p_d / 2.
template <int NKEY>
__global__ void __launch_bounds__(1024)
    ks_epilogue_row_kernel(const uint32_t* __restrict__ acc0,
                           const uint32_t* __restrict__ acc1,
                           const uint32_t* __restrict__ scratch,
                           uint32_t* __restrict__ out0,
                           uint32_t* __restrict__ out1,
                           const uint32_t* __restrict__ qs,
                           const uint32_t* __restrict__ wi,
                           const uint32_t* __restrict__ wpi,
                           const uint32_t* __restrict__ ninv,
                           const uint32_t* __restrict__ ninvp,
                           const uint32_t* __restrict__ wf,
                           const uint32_t* __restrict__ wpf,
                           const uint32_t* __restrict__ pdiv, int batch,
                           int n_ext, int out_ntt, int logn) {
  extern __shared__ uint32_t s[];
  // The division's constants, gathered once: for step d, cst[4d ..] = p_d,
  // p_d / 2, and the Shoup pair of p_d^-1 mod q_r; at kinv + 2 (d NKEY +
  // kk) the pair mod key prime kk; at kq + kk that prime.
  constexpr int kinv = 4 * NKEY, kq = kinv + 2 * NKEY * NKEY;
  __shared__ uint32_t cst[kq + NKEY];
  const int n = 1 << logn;
  const int n_out = n_ext - NKEY;
  const int n_cur = n_out;
  const int r = blockIdx.x % n_out;
  const int b = (blockIdx.x / n_out) % batch;
  const int a = blockIdx.x / (n_out * batch);
  const uint32_t q = qs[r];
  const uint32_t* src = (a ? acc1 : acc0) + ((size_t)b * n_ext + r) * n;
  const uint32_t* keys = scratch + ((size_t)a * batch + b) * NKEY * n;

  if (threadIdx.x < NKEY) {
    const int d = threadIdx.x;
    const uint32_t* pd = pdiv + (size_t)d * (2 * n_ext + 2);
    cst[4 * d] = pd[2 * n_ext];
    cst[4 * d + 1] = pd[2 * n_ext + 1];
    cst[4 * d + 2] = pd[r];
    cst[4 * d + 3] = pd[n_ext + r];
    for (int kk = 0; kk < NKEY; ++kk) {
      cst[kinv + 2 * (d * NKEY + kk)] = pd[n_cur + kk];
      cst[kinv + 2 * (d * NKEY + kk) + 1] = pd[n_ext + n_cur + kk];
    }
    cst[kq + d] = qs[n_cur + d];
  }
  load_row(s, src, n);
  __syncthreads();
  ntt_inv_row(s, wi + (size_t)r * n, wpi + (size_t)r * n, q, ninv[r],
              ninvp[r], logn);

  // From here on the key kernel's scratch is read. Each thread divides
  // kDivBatch elements at a time, their key loads in flight together.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  constexpr int kDivBatch = 4;
  const int T = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += kDivBatch * T) {
    uint32_t key[kDivBatch][NKEY], x[kDivBatch];
#pragma unroll
    for (int u = 0; u < kDivBatch; ++u) {
#pragma unroll
      for (int kk = 0; kk < NKEY; ++kk)
        key[u][kk] = keys[(size_t)kk * n + e0 + u * T];
      x[u] = s[swz(e0 + u * T)];
    }
#pragma unroll
    for (int d = 0; d < NKEY; ++d) {
      const int last = NKEY - 1 - d;  // key row of the dropped prime
      const uint32_t p = cst[4 * d], p_half = cst[4 * d + 1];
      const uint32_t w = cst[4 * d + 2], wp = cst[4 * d + 3];
#pragma unroll
      for (int u = 0; u < kDivBatch; ++u) {
        const uint32_t lift = key[u][last];  // its coefficient, < p
        const uint32_t shift = p - lift;     // x + shift < 2^32
        const uint32_t corr = lift > p_half ? 0u : 1u;
        x[u] = sub_mod_r(shoup_mul_r(x[u] + shift, w, wp, q), corr, q);
#pragma unroll
        for (int kk = 0; kk < last; ++kk) {
          const uint32_t qk = cst[kq + kk];
          const int c = kinv + 2 * (d * NKEY + kk);
          key[u][kk] = sub_mod_r(
              shoup_mul_r(key[u][kk] + shift, cst[c], cst[c + 1], qk), corr,
              qk);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDivBatch; ++u) s[swz(e0 + u * T)] = x[u];
  }
  __syncthreads();
  if (out_ntt)
    ntt_fwd_row(s, wf + (size_t)r * n, wpf + (size_t)r * n, q, logn);

  uint32_t* dst = (a ? out1 : out0) + ((size_t)b * n_out + r) * n;
  for (int e = threadIdx.x; e < n; e += T) dst[e] = s[swz(e)];
}

using RowKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                           uint32_t*, uint32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, int, int, int, int);

// The row kernel for n_key key primes, or null when n_key is out of range.
RowKernel row_kernel(int n_key) {
  switch (n_key) {
    case 1: return ks_epilogue_row_kernel<1>;
    case 2: return ks_epilogue_row_kernel<2>;
    case 3: return ks_epilogue_row_kernel<3>;
    case 4: return ks_epilogue_row_kernel<4>;
    case 5: return ks_epilogue_row_kernel<5>;
    case 6: return ks_epilogue_row_kernel<6>;
    case 7: return ks_epilogue_row_kernel<7>;
    case 8: return ks_epilogue_row_kernel<8>;
    default: return nullptr;
  }
}

using MacKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, const int64_t*,
                           const uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, uint32_t*, uint32_t*, int, int,
                           int, int, int);

// The MAC kernel for a row of 2^logn (PER = N / row_threads words per
// thread and accumulator), or null when logn is out of range.
MacKernel mac_kernel(int logn) {
  const int threads = row_threads(logn);
  if (threads == 0) return nullptr;
  switch ((1 << logn) / threads) {
    case 8: return ks_mac_cluster_kernel<8>;
    case 16: return ks_mac_cluster_kernel<16>;
    case 32: return ks_mac_cluster_kernel<32>;
    default: return nullptr;
  }
}

// The MAC's launch configuration for a cluster of C blocks.
struct MacLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;

  MacLaunch(int logn, int C, int grid_x, int batch, cudaStream_t stream)
      : cfg(), attr() {
    cfg.gridDim = dim3(grid_x, batch);
    cfg.blockDim = dim3(row_threads(logn));
    cfg.dynamicSmemBytes = sizeof(uint32_t) << logn;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  MacLaunch(const MacLaunch&) = delete;
};

// How many clusters of C MAC blocks the device holds at once.
cudaError_t mac_clusters(int logn, int C, int* count) {
  MacLaunch l(logn, C, C, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(count, (const void*)mac_kernel(logn),
                                        &l.cfg);
}

// The cluster size of a MAC launch of `clusters` = n_ext * B clusters over
// n_groups digits: the C <= min(n_groups, 8) that takes the fewest rounds
// of row transforms, ceil(clusters / held(C)) waves of ceil(n_groups / C)
// digits per rank, the larger C on a tie. At Sobel's level 0 that is C = 6
// at B = 1 (13 clusters, 17 held at once) and C = 2 at B = 4 (52 clusters
// of 2, 66 held, against 4 waves of clusters of 6). held(C) is asked of
// the device once per ring size and C, and kept.
cudaError_t mac_cluster_size(int logn, int n_groups, int clusters, int* C) {
  static int held[kMaxLogN + 1][kMaxCluster + 1];  // count + 1; 0: not asked
  long best = 0;
  *C = 0;
  for (int c = n_groups < kMaxCluster ? n_groups : kMaxCluster; c >= 1; --c) {
    if (held[logn][c] == 0) {
      int count = 0;
      const cudaError_t err = mac_clusters(logn, c, &count);
      if (err != cudaSuccess) return err;
      held[logn][c] = count + 1;
    }
    const long count = held[logn][c] - 1;
    if (count == 0) continue;
    const long rounds =
        (clusters + count - 1) / count * (long)((n_groups + c - 1) / c);
    if (*C == 0 || rounds < best) {
      best = rounds;
      *C = c;
    }
  }
  return *C ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename K>
cudaError_t opt_in(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmemMax);
}

}  // namespace

extern "C" {

// Opt every kernel in to the dynamic shared memory of one row at the
// largest ring (128 KB) on the current device, and check that the device
// holds a cluster of 8 MAC blocks at every ring size.
int eva_ks_init() {
  cudaError_t err;
  if ((err = opt_in(ks_epilogue_key_kernel)) != cudaSuccess) return (int)err;
  for (int k = 1; k <= kMaxKey; ++k)
    if ((err = opt_in(row_kernel(k))) != cudaSuccess) return (int)err;
  for (int logn = kMinLogN; logn <= kMaxLogN; ++logn) {
    int count = 0;
    if ((err = opt_in(mac_kernel(logn))) != cudaSuccess ||
        (err = mac_clusters(logn, kMaxCluster, &count)) != cudaSuccess)
      return (int)err;
    if (count == 0) return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

// Resource use at a ring of 2^logn, for reports: out[0..5] = registers per
// thread and local (spill) bytes per thread of the MAC, key and row
// kernels (the row kernel for n_key key primes); out[6] = threads per
// block; out[7 + c - 1] = the clusters of c MAC blocks the device holds at
// once, c = 1 .. 8.
int eva_ks_info(int logn, int n_key, int* out) {
  const MacKernel mac = mac_kernel(logn);
  const RowKernel row = row_kernel(n_key);
  if (mac == nullptr || row == nullptr) return (int)cudaErrorInvalidValue;
  const void* fns[3] = {(const void*)mac, (const void*)ks_epilogue_key_kernel,
                        (const void*)row};
  cudaError_t err;
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fns[k])) != cudaSuccess)
      return (int)err;
    out[2 * k] = attr.numRegs;
    out[2 * k + 1] = (int)attr.localSizeBytes;
  }
  out[6] = row_threads(logn);
  for (int c = 1; c <= kMaxCluster; ++c)
    if ((err = mac_clusters(logn, c, &out[6 + c])) != cudaSuccess)
      return (int)err;
  return 0;
}

// The cluster size C that a MAC launch of `clusters` = n_ext * B clusters
// over n_groups digits takes at a ring of 2^logn (mac_cluster_size), for
// reports.
int eva_ks_mac_cluster(int logn, int n_groups, int clusters, int* c) {
  if (mac_kernel(logn) == nullptr || n_groups <= 0 || clusters <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)mac_cluster_size(logn, n_groups, clusters, c);
}

// The MAC for `batch` elements; returns the cudaError_t of the launch.
// x_ntt may be null (no own-row reads).
int eva_ks_mac(const void* y, const void* x_ntt, const void* k0,
               const void* k1, const void* conv, const void* owner,
               const void* q, const void* nqinv, const void* w,
               const void* wp, void* acc0, void* acc1, int batch,
               int n_groups, int alpha, int n_ext, int n_cur, int logn,
               void* stream) {
  const MacKernel kernel = mac_kernel(logn);
  if (kernel == nullptr || batch <= 0 || batch > 65535 || n_groups <= 0 ||
      alpha <= 0 || n_ext <= 0 || n_cur < 0 || n_cur > n_ext)
    return (int)cudaErrorInvalidValue;
  int C;
  cudaError_t err = mac_cluster_size(logn, n_groups, n_ext * batch, &C);
  if (err != cudaSuccess) return (int)err;
  MacLaunch l(logn, C, n_ext * C, batch, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(
      &l.cfg, kernel, (const uint32_t*)y, (const uint32_t*)x_ntt,
      (const uint32_t*)k0, (const uint32_t*)k1, (const uint32_t*)conv,
      (const int64_t*)owner, (const uint32_t*)q, (const uint32_t*)nqinv,
      (const uint32_t*)w, (const uint32_t*)wp, (uint32_t*)acc0,
      (uint32_t*)acc1, n_groups, alpha, n_ext, n_cur, logn);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The epilogue for `batch` elements: the key-row inverse NTTs into
// `scratch` ([2, batch, n_key, N] uint32), and the row pass, launched as
// its programmatic dependent, into out0 / out1 ([batch, n_ext - n_key, N]
// uint32). Returns the first launch's error, if any.
int eva_ks_epilogue(const void* acc0, const void* acc1, void* scratch,
                    void* out0, void* out1, const void* q, const void* wi,
                    const void* wpi, const void* ninv, const void* ninvp,
                    const void* wf, const void* wpf, const void* pdiv,
                    int batch, int n_ext, int n_key, int out_ntt, int logn,
                    void* stream) {
  const int threads = row_threads(logn);
  const RowKernel row = row_kernel(n_key);
  if (threads == 0 || row == nullptr || batch <= 0 || n_key >= n_ext)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << logn;
  cudaStream_t st = (cudaStream_t)stream;
  ks_epilogue_key_kernel<<<2 * batch * n_key, threads, smem, st>>>(
      (const uint32_t*)acc0, (const uint32_t*)acc1, (uint32_t*)scratch,
      (const uint32_t*)q, (const uint32_t*)wi, (const uint32_t*)wpi,
      (const uint32_t*)ninv, (const uint32_t*)ninvp, batch, n_ext, n_key,
      logn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * batch * (n_ext - n_key));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, row, (const uint32_t*)acc0,
      (const uint32_t*)acc1, (const uint32_t*)scratch, (uint32_t*)out0,
      (uint32_t*)out1, (const uint32_t*)q, (const uint32_t*)wi,
      (const uint32_t*)wpi, (const uint32_t*)ninv, (const uint32_t*)ninvp,
      (const uint32_t*)wf, (const uint32_t*)wpf, (const uint32_t*)pdiv, batch,
      n_ext, out_ntt, logn);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
