// Fused hybrid key switch for Hopper (sm_90a): the digit MAC and the
// P-division epilogue.
//
// Replaces the TPU kernels of the JAX package:
//   eva_tpu/backend/pallas_ks.py  _mac_kernel       (PallasKeySwitch.mac)
//   eva_tpu/backend/pallas_ks.py  _epilogue_kernel  (PallasEpilogue.epilogue)
// and computes the same values (every step is exact modular arithmetic;
// the row NTTs are the merged-psi schedule of ntt_common.cuh: the MAC's
// whole-row ntt_fwd_row, the epilogue's cluster passes). Plain PyTorch
// versions: eva_tpu_torch/backend/ks.py.
//
// Data is uint32 words throughout (int32 tensors carrying the residues'
// uint32 bits; residues < q < 2^31): in device memory, in shared memory
// (in the swizzled order of ntt_common.cuh) and in registers. Only the
// digit-owner table is int64 (an index).
// Row i of the extended basis (the level's n_cur data primes, then the
// n_key key primes) uses prime i and row i of the [n_ext, N] twiddle
// tables. MAC blocks have seg_threads(logn, 0) threads: 1024 from N = 8192
// up.
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
// programmatic dependent launch, each row split over a thread-block
// cluster of C blocks as ntt.cu's K1 and K2 split theirs, on the same
// cluster passes (ntt_common.cuh): a row of N is C segments of N / C
// words, one in each block's shared memory; the 3 stages of the largest
// strides run on S-strided groups (S = N / 8) read and written through
// distributed shared memory, every other stage in segment-local register
// passes.
//   ks_epilogue_key_kernel, one cluster per (accumulator a, b, key row
//      kk): lets its dependent grid launch at once, then the inverse NTT
//      of key row kk into a uint32 scratch (seg_inv_row: K2's schedule).
//   ks_epilogue_row_kernel<n_key>, one cluster per (a, b, output row r),
//      launched with programmatic stream serialization, so it runs beside
//      the key kernel: the inverse NTT of row r (seg_inv_local, then the
//      last 3 stages on its S-strided groups, N^-1 folded in, each group
//      written back where it was read: its words belong to that thread
//      alone); a cluster barrier; it waits for the key kernel's grid
//      (griddepcontrol.wait); then each block divides its own segment:
//      for each key prime, the last first, the centred divide-and-round
//      of each word, lifting the key rows' coefficients at the same
//      indices from the scratch on the way (kDiv words a thread at a
//      time, their loads in flight together). With out_ntt, a cluster
//      barrier, the forward's first 3 stages on the S-strided groups in
//      place, another, then its local passes, the last straight to
//      device memory as 16-byte words; without, the division writes
//      device memory. Three phases, each as light on registers as K1's
//      and K2's: a single pass holding a group through the inverse, the
//      division and the forward spilled at 64 registers (44 bytes a
//      thread at n_key 2) and ran ~10% faster (PERF.md).
// Device memory sees each row read once and written once; no transform
// walks a whole row on one SM. The critical path is two cluster
// transforms (the key rows' inverse, then the division and the forward;
// the row kernel's own inverse overlaps the first).
// C (epilogue_cluster) is chosen from the launch: the ring size and the
// 2 B n_ext row transforms, by waves of what the card holds at once
// (cudaOccupancyMaxActiveClusters of the row kernel, asked once per ring
// and kept) times the groups a thread takes a pass, as mac_cluster_size
// chooses K4's: at B = 1 the largest the ring splits into (segments of
// >= 1024 words: C = 1 at N = 1024, 8 from N = 8192 up); at N = 32768,
// n_ext 16 and B = 4, C = 2 (C = 8 would take five waves and lost to
// C = 1, PERF.md). The key and row kernels take the same C.
// What bounds it: at Sobel's level 0 (N = 16384, n_ext 13, n_key 2, B = 1)
// it moves 3.1 MB (0.9 us at 3.35 TB/s) and runs 48 row NTTs plus the
// divisions, ~86M 32-bit operations (5.1 us at 16.7e12 op/s); at N = 32768
// with n_ext 10 (cryptonets' key switches), 36 row NTTs, ~137M operations
// (8.2 us): operations.
//
// Resources on the H100 (chip_smoke.py prints them, from eva_ks_info;
// nvcc -Xptxas -v at build): 1024 threads per MAC block from N = 8192 up,
// so a thread may hold 64 registers and each SM holds one MAC block. The
// MAC kernel uses all 64 and spills 48 bytes per thread at N = 16384 (208
// at N = 32768: its 2 x 32 accumulators). A cluster of 8 MAC blocks fits
// the card 15 times at once, of 6 17 times. The bulk L2 prefetch of the
// key rows moves little: it costs 2% at B = 1 and saves 2% at B = 4
// (PERF.md). The epilogue's blocks have N / C / 8 threads (at most 1024:
// 256 at N = 16384 and 512 at N = 32768 with C = 8); the key kernel uses
// 56 registers, the row kernel 62 (n_key 1, 2) or 64 (n_key 3, 4), none
// spills up to n_key 4 (the row kernel spills 28-352 bytes at n_key 5-8,
// which no cell runs). The card holds 62 clusters of 8 at N = 16384, 30
// at N = 32768.
// Measured (PERF.md, by CUDA-graph replays, n_key 2, out_ntt, B = 1): at
// Sobel's level 0 14.3 us (one block a row: 34.8 us; bound 5.1), 32.0 at
// B = 4 (35.8; bound 20.6); at N = 32768, n_ext 10, 22.0 us (66.7; bound
// 8.2), n_ext 16 26.9 us (66.7). Left on the table: at B = 1 the
// transforms are latency (cluster barriers, device-memory round trips),
// not throughput; one pass holding each group through the inverse, the
// division and the forward needs more than 64 registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

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

// The MAC's FBE computes kBatch elements per thread at a time, so each
// thread has kBatch loads in flight (N is a multiple of kBatch *
// blockDim.x).
constexpr int kBatch = 8;

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

// Cluster (a, b, kk) of C blocks: the inverse NTT of key row kk (ext row
// n_ext - n_key + kk) of accumulator a, batch b, into scratch[a, b, kk]
// (uint32), the row split over the cluster (seg_inv_row).
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
  cg::cluster_group cluster = cg::this_cluster();
  const Seg sg(cluster, logn);
  const size_t n = (size_t)1 << logn;
  const int k = blockIdx.x >> sg.c;  // (a, b, kk)
  const int kk = k % n_key;
  const int b = (k / n_key) % batch;
  const int a = k / (n_key * batch);
  const int row = n_ext - n_key + kk;
  seg_inv_row(cluster, s, (a ? acc1 : acc0) + ((size_t)b * n_ext + row) * n,
              scratch + (size_t)k * n, wi + row * n, wpi + row * n, qs[row],
              ninv + row, ninvp + row, sg, logn);
}

// The centred divide-and-round of x (a coefficient mod q) by the NKEY key
// primes, the last first, given its key lifts key[kk] (key row kk's
// coefficient at the same index, mod key prime kk); key rows below the
// dropped prime are lifted on in place. cst: the row kernel's constants.
template <int NKEY>
__device__ __forceinline__ uint32_t divide_by_keys(uint32_t x,
                                                   uint32_t (&key)[NKEY],
                                                   const uint32_t* cst,
                                                   uint32_t q) {
  constexpr int kinv = 4 * NKEY, kq = kinv + 2 * NKEY * NKEY;
#pragma unroll
  for (int d = 0; d < NKEY; ++d) {
    const int last = NKEY - 1 - d;  // key row of the dropped prime
    const uint32_t p = cst[4 * d], p_half = cst[4 * d + 1];
    const uint32_t lift = key[last];  // its coefficient, < p
    const uint32_t shift = p - lift;  // x + shift < 2^32
    const uint32_t corr = lift > p_half ? 0u : 1u;
    x = sub_mod_r(shoup_mul_r(x + shift, cst[4 * d + 2], cst[4 * d + 3], q),
                  corr, q);
#pragma unroll
    for (int kk = 0; kk < last; ++kk) {
      const uint32_t qk = cst[kq + kk];
      const int c = kinv + 2 * (d * NKEY + kk);
      key[kk] = sub_mod_r(
          shoup_mul_r(key[kk] + shift, cst[c], cst[c + 1], qk), corr, qk);
    }
  }
  return x;
}

// Cluster (a, b, r) of C blocks, r < n_out = n_ext - n_key: row r of
// d_a[b], for n_key = NKEY (one kernel per key-prime count, so the
// division's key values and loops live in registers), the row split over
// the cluster as the key kernel's.
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
  cg::cluster_group cluster = cg::this_cluster();
  const Seg sg(cluster, logn);
  const size_t n = (size_t)1 << logn;
  const int n_out = n_ext - NKEY;
  const int n_cur = n_out;
  const int k = blockIdx.x >> sg.c;  // (a, b, r)
  const int r = k % n_out;
  const int b = (k / n_out) % batch;
  const int a = k / (n_out * batch);
  const uint32_t q = qs[r];
  const uint32_t* wir = wi + r * n;
  const uint32_t* wpir = wpi + r * n;

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
  // The inverse's local stages (their closing __syncthreads also publishes
  // cst), beside the key kernel's.
  seg_inv_local(s, (a ? acc1 : acc0) + ((size_t)b * n_ext + r) * n, wir,
                wpir, q, sg, logn);
  cluster_arrive();
  cluster_wait();

  const uint32_t* keys = scratch + ((size_t)a * batch + b) * NKEY * n;
  uint32_t* dst = (a ? out1 : out0) + ((size_t)b * n_out + r) * n;
  const uint32_t* wfr = wf + r * n;
  const uint32_t* wpfr = wpf + r * n;
  const uint32_t nv = ninv[r], nvp = ninvp[r];
  constexpr int G0 = 1 << kPassLog;
  const int ls = logn - kPassLog;
  const int per = 1 << (ls - sg.c);
  // The inverse's last 3 stages (N^-1 folded in) on this block's strided
  // groups, each written back where it was read: its words belong to its
  // thread alone, so no barrier separates the other blocks' reads.
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    const int g = sg.b * per + j;
    uint32_t v[G0];
#pragma unroll
    for (int u = 0; u < G0; ++u)
      v[u] = *seg_word(cluster, s, sg, g + (u << ls));
    inv_group<kPassLog>(v, wir, wpir, q, 1, true, nv, nvp);
#pragma unroll
    for (int u = 0; u < G0; ++u)
      *seg_word(cluster, s, sg, g + (u << ls)) = v[u];
  }
  // From here on the key kernel's scratch is read.
  cluster_arrive();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  cluster_wait();
  // The division, on this block's own segment: kDiv words a thread at a
  // time, their key lifts in flight together (kDiv x NKEY registers).
  const int T = blockDim.x;
  constexpr int kDiv = NKEY <= 4 ? 4 : 2;
  const uint32_t* kseg = keys + ((size_t)sg.b << sg.logl);
  uint32_t* dseg = dst + ((size_t)sg.b << sg.logl);
  for (int e0 = threadIdx.x; e0 < sg.L; e0 += kDiv * T) {
    uint32_t key[kDiv][NKEY], x[kDiv];
#pragma unroll
    for (int u = 0; u < kDiv; ++u) {
#pragma unroll
      for (int kk = 0; kk < NKEY; ++kk) key[u][kk] = kseg[kk * n + e0 + u * T];
      x[u] = s[swz(e0 + u * T)];
    }
#pragma unroll
    for (int u = 0; u < kDiv; ++u) {
      x[u] = divide_by_keys<NKEY>(x[u], key[u], cst, q);
      if (out_ntt) s[swz(e0 + u * T)] = x[u];
      else dseg[e0 + u * T] = x[u];
    }
  }
  if (!out_ntt) return;
  // The forward's first 3 stages on the same groups, in place, then its
  // local passes once every segment holds its words.
  cluster_arrive();
  cluster_wait();
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    const int g = sg.b * per + j;
    uint32_t v[G0];
#pragma unroll
    for (int u = 0; u < G0; ++u)
      v[u] = *seg_word(cluster, s, sg, g + (u << ls));
    fwd_group<kPassLog>(v, wfr, wpfr, q, 1);
#pragma unroll
    for (int u = 0; u < G0; ++u)
      *seg_word(cluster, s, sg, g + (u << ls)) = v[u];
  }
  cluster_arrive();
  cluster_wait();
  seg_fwd_local(s, dst, wfr, wpfr, q, sg);
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

// The MAC kernel for a row of 2^logn (PER = N / seg_threads(logn, 0)
// words per thread and accumulator), or null when logn is out of range.
MacKernel mac_kernel(int logn) {
  const int threads = seg_threads(logn, 0);
  if (threads == 0) return nullptr;
  switch ((1 << logn) / threads) {
    case 8: return ks_mac_cluster_kernel<8>;
    case 16: return ks_mac_cluster_kernel<16>;
    case 32: return ks_mac_cluster_kernel<32>;
    default: return nullptr;
  }
}

// The MAC's launch configuration: clusters of C blocks, a whole row each.
struct MacLaunch : ClusterLaunch {
  MacLaunch(int logn, int C, int grid_x, int batch, cudaStream_t stream)
      : ClusterLaunch(dim3(grid_x, batch), seg_threads(logn, 0),
                      sizeof(uint32_t) << logn, C, stream) {}
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

// An epilogue launch of `rows` row transforms in clusters of 2^c blocks
// (pdl: as the programmatic dependent of the grid before it).
struct EpilogueLaunch : ClusterLaunch {
  EpilogueLaunch(int logn, int c, int rows, cudaStream_t stream, bool pdl)
      : ClusterLaunch(dim3(rows << c), seg_threads(logn, c),
                      sizeof(uint32_t) << (logn - c), 1 << c, stream, pdl) {}
};

// How many clusters of 2^c row-kernel blocks (n_key key primes) the
// device holds at once, asked once per ring size and kept.
cudaError_t epilogue_held(int logn, int n_key, int c, int* count) {
  static int held[kMaxKey + 1][kMaxLogN + 1][kMaxClusterLog + 1];  // + 1
  int& h = held[n_key][logn][c];
  if (h == 0) {
    EpilogueLaunch l(logn, c, 1, nullptr, false);
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &h, (const void*)row_kernel(n_key), &l.cfg);
    if (err != cudaSuccess) {
      h = 0;
      return err;
    }
    ++h;
  }
  *count = h - 1;
  return cudaSuccess;
}

// The cluster size 2^c of an epilogue of `rows` = 2 B n_ext row transforms
// (the key and row kernels' together) at a ring of 2^logn: the c that
// takes the fewest rounds, ceil(rows / held(c)) waves of clusters, each
// pass of a wave giving a thread N / 2^c / (8 threads) groups of 8 words,
// the larger c on a tie, among the c the ring splits into (segments of
// >= 1024 words: N = 1024 takes c = 0). At B = 1 every c takes one wave
// and C = 8 gives a thread one group a pass, so it wins from N = 8192 up;
// a batch that fills the card several times over takes less (at N =
// 32768, 2 x 4 x 16 rows: C = 8 five waves of one group, C = 2 two of
// two, C = 1 one of four).
cudaError_t epilogue_cluster(int logn, int n_key, int rows, int* c_out) {
  long best = 0;
  *c_out = -1;
  for (int c = kMaxClusterLog; c >= 0; --c) {
    const int threads = seg_threads(logn, c);
    if (threads == 0) continue;
    int count;
    const cudaError_t err = epilogue_held(logn, n_key, c, &count);
    if (err != cudaSuccess) return err;
    if (count == 0) continue;
    const long rounds = (long)((rows + count - 1) / count) *
                        ((1 << (logn - c)) / (8 * threads));
    if (*c_out < 0 || rounds < best) {
      best = rounds;
      *c_out = c;
    }
  }
  return *c_out >= 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
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
// kernels (the row kernel for n_key key primes); out[6] = threads per MAC
// block; out[7 + c - 1] = the clusters of c MAC blocks the device holds at
// once, c = 1 .. 8; out[15] = the cluster size C of an epilogue at B = 1
// over n_ext rows (2 n_ext row transforms), out[16] its threads per block;
// out[17 + c] = the clusters of 2^c row-kernel blocks the device holds at
// once, c = 0 .. 3 (0 where the ring does not split so).
int eva_ks_info(int logn, int n_key, int n_ext, int* out) {
  const MacKernel mac = mac_kernel(logn);
  const RowKernel row = row_kernel(n_key);
  if (mac == nullptr || row == nullptr || n_ext <= n_key)
    return (int)cudaErrorInvalidValue;
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
  out[6] = seg_threads(logn, 0);
  for (int c = 1; c <= kMaxCluster; ++c)
    if ((err = mac_clusters(logn, c, &out[6 + c])) != cudaSuccess)
      return (int)err;
  int c;
  if ((err = epilogue_cluster(logn, n_key, 2 * n_ext, &c)) != cudaSuccess)
    return (int)err;
  out[15] = 1 << c;
  out[16] = seg_threads(logn, c);
  for (c = 0; c <= kMaxClusterLog; ++c) {
    out[17 + c] = 0;
    if (seg_threads(logn, c) &&
        (err = epilogue_held(logn, n_key, c, &out[17 + c])) != cudaSuccess)
      return (int)err;
  }
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
// uint32), both in clusters of the C that *cluster receives
// (epilogue_cluster). Returns the first launch's error, if any.
int eva_ks_epilogue(const void* acc0, const void* acc1, void* scratch,
                    void* out0, void* out1, const void* q, const void* wi,
                    const void* wpi, const void* ninv, const void* ninvp,
                    const void* wf, const void* wpf, const void* pdiv,
                    int batch, int n_ext, int n_key, int out_ntt, int logn,
                    int* cluster, void* stream) {
  const RowKernel row = row_kernel(n_key);
  if (seg_threads(logn, 0) == 0 || row == nullptr || batch <= 0 ||
      n_key >= n_ext || (long)batch * n_ext > (1 << 26))
    return (int)cudaErrorInvalidValue;
  int c;
  cudaError_t err = epilogue_cluster(logn, n_key, 2 * batch * n_ext, &c);
  if (err != cudaSuccess) return (int)err;
  *cluster = 1 << c;
  cudaStream_t st = (cudaStream_t)stream;
  EpilogueLaunch key(logn, c, 2 * batch * n_key, st, false);
  err = cudaLaunchKernelEx(
      &key.cfg, ks_epilogue_key_kernel, (const uint32_t*)acc0,
      (const uint32_t*)acc1, (uint32_t*)scratch, (const uint32_t*)q,
      (const uint32_t*)wi, (const uint32_t*)wpi, (const uint32_t*)ninv,
      (const uint32_t*)ninvp, batch, n_ext, n_key, logn);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return (int)err;
  EpilogueLaunch rows(logn, c, 2 * batch * (n_ext - n_key), st, true);
  err = cudaLaunchKernelEx(
      &rows.cfg, row, (const uint32_t*)acc0, (const uint32_t*)acc1,
      (const uint32_t*)scratch, (uint32_t*)out0, (uint32_t*)out1,
      (const uint32_t*)q, (const uint32_t*)wi, (const uint32_t*)wpi,
      (const uint32_t*)ninv, (const uint32_t*)ninvp, (const uint32_t*)wf,
      (const uint32_t*)wpf, (const uint32_t*)pdiv, batch, n_ext, out_ntt,
      logn);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
