// Negacyclic NTT and inverse NTT over RNS limb planes, for Hopper (sm_90a),
// each row split over a thread-block cluster.
//
// Replaces the TPU kernels of the JAX package:
//   eva_tpu/backend/pallas_ntt.py     _fwd_kernel, _inv_kernel (PallasNTT)
//   eva_tpu/backend/pallas_ntt_v2.py  _fwd_kernel_v2, _inv_kernel_v2
// All of them compute the same values as the Harvey merged-psi schedule of
// eva_tpu/backend/tables.py (_fwd_merged / _inv_merged), which is what this
// file runs, on the register-radix passes of ntt_common.cuh: forward takes
// natural order in and gives bit-reversed order out; the inverse takes
// bit-reversed in, gives natural out, and folds N^-1 into its last stage.
// Every output is the canonical residue, so results equal the TPU
// kernels' and the host tables' bit for bit.
//
// Layout: data is [rows, N] uint32 words (int32 tensors carrying the
// residues' uint32 bits; residues < q < 2^31), row r uses prime r % n_sub.
// Twiddle tables are [n_sub, N] uint32 Shoup pairs (w, w'): stage m reads
// entries [m, 2m).
//
// What bounds it on this card: a row of N residues is read once and
// written once (8N bytes) beside its prime's twiddle pairs (8N bytes), and
// takes N/2 log2(N) butterflies of ~14 32-bit integer operations. At
// Sobel's level 0 ([11, 16384], batch 1) that is 2.9 MB (0.86 us at 3.35
// TB/s) against 17.7M operations (1.06 us at the 16.7e12 int32 op/s of 132
// SMs x 64 INT32 lanes): operations, narrowly. At batch 1
// the main path calls it on 2 to 12 rows in most launches, so one block
// per row would leave most of the 132 SMs idle and walk each row's 14
// stages on one SM.
//
// The design is the TPU kernel's four-step split, with the cluster as the
// split: a row of N is cut into C segments of L = N / C elements, one per
// block of a cluster of C (cudaLaunchKernelEx with a cluster dimension;
// grid rows * C), each segment in its block's shared memory (4L bytes,
// swizzled as swz). Write S = N / 8.
//   Forward: the first 3 stages pair elements S apart, across segments for
//   the first log2 C of them. Block b takes 1/C of the S groups
//   {g + u S : u < 8}, loads each from device memory straight into
//   registers, runs the 3 stages there (fwd_group), and writes element u
//   into the shared memory of the segment that holds it (map_shared_rank:
//   distributed shared memory). One cluster barrier, then the remaining
//   log2 N - 3 stages are local to each segment: register passes of 3
//   stages (ntt_fwd_pass with top = C + b), the last of which stores its
//   groups, contiguous by then, to device memory as 16-byte words (one
//   8-byte word a group when the last pass has one stage).
//   Inverse: the mirror image. The first local pass loads contiguous
//   groups from device memory, the local passes run the first log2 N - 3
//   stages, a cluster barrier, then the last 3 stages on the S-strided
//   groups read through distributed shared memory, with N^-1 folded into
//   the final stage, stored to device memory. A closing cluster barrier
//   keeps every block's shared memory alive until the others have read it.
// Device memory sees each element read once and written once, as in a
// block-per-row kernel; C blocks on C SMs share the 14 stages of a row.
// C (choose_cluster) is the largest of 1, 2, 4, 8 with L >= 1024 (so
// N = 1024 takes C = 1, N >= 8192 takes 8) of which the card holds a
// cluster (cudaOccupancyMaxActiveClusters, asked once per ring size and
// kept). Blocks have L / 8 threads (8 words per thread per pass; at most
// 1024), so several small blocks share an SM. A failed launch returns its
// error; nothing falls back to another kernel.
// Measured on the H100 (PERF.md): at batch 1 (2 to 13 rows) a launch takes
// ~6 us, almost all of it latency (launch, the device-memory round trip,
// five passes each ending in a barrier), not throughput; at [4, 13] rows
// ~2x the operations bound. Clusters of 16 (non-portable) were tried:
// their 16-word groups spill at 64 registers and ran no faster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace eva;

constexpr int kMaxClusterLog = 3;  // C = 8: the portable cluster size
constexpr int kMinSegLog = 10;     // segments of at least 1024 words
constexpr int kMaxRows = 1 << 27;  // rows * 8 blocks fit the grid

// The split phases of the cluster barrier. A thread arrives, may go on
// with work that does not depend on the other blocks, then waits; arrive
// releases this thread's shared-memory writes to the cluster, and wait
// acquires the others'.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Where a kernel's block stands: its cluster (C = 2^c blocks, rank b),
// row, prime and segment.
struct Seg {
  int c, C, b, logl, L, p;
  size_t row;  // the row's first element in device memory

  __device__ Seg(cg::cluster_group& cluster, int n_sub, int logn) {
    C = (int)cluster.num_blocks();
    b = (int)cluster.block_rank();
    c = __ffs(C) - 1;
    logl = logn - c;
    L = 1 << logl;
    const int r = blockIdx.x >> c;
    p = r % n_sub;
    row = (size_t)r << logn;
  }
};

// The forward's last pass over a segment of L: its groups of 2^RP are
// contiguous (group g at [g 2^RP, (g + 1) 2^RP), twiddle blocks led by
// kb0 + g), and go from registers straight to dst as 16-byte words (a
// group of 2 as one 8-byte word).
template <int RP>
__device__ __forceinline__ void fwd_store_pass(
    const uint32_t* s, uint32_t* __restrict__ dst,
    const uint32_t* __restrict__ wr, const uint32_t* __restrict__ wpr,
    uint32_t q, int L, int kb0) {
  constexpr int G = 1 << RP;
  for (int g = threadIdx.x; g < (L >> RP); g += blockDim.x) {
    uint32_t v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = s[swz((g << RP) + u)];
    fwd_group<RP>(v, wr, wpr, q, kb0 + g);
    if constexpr (G >= 4) {
      uint4* d = reinterpret_cast<uint4*>(dst + (g << RP));
#pragma unroll
      for (int u = 0; u < G; u += 4)
        d[u / 4] = make_uint4(v[u], v[u + 1], v[u + 2], v[u + 3]);
    } else {
      *reinterpret_cast<uint2*>(dst + (g << RP)) = make_uint2(v[0], v[1]);
    }
  }
}

__global__ void __launch_bounds__(1024)
    ntt_fwd_kernel(const uint32_t* __restrict__ in,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ w,
                   const uint32_t* __restrict__ wp,
                   const uint32_t* __restrict__ qs, int n_sub, int logn) {
  extern __shared__ uint32_t s[];
  // Every block of the cluster must have started before another writes
  // into its shared memory: arrive now, wait before the first such write.
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const Seg sg(cluster, n_sub, logn);
  const uint32_t q = qs[sg.p];
  const uint32_t* wr = w + ((size_t)sg.p << logn);
  const uint32_t* wpr = wp + ((size_t)sg.p << logn);
  const uint32_t* src = in + sg.row;

  // The first 3 stages, on the S-strided groups of the whole row; the
  // owner of element u of a group is segment u >> (3 - c).
  constexpr int G0 = 1 << kPassLog;
  const int ls = logn - kPassLog;    // log2 S
  const int per = 1 << (ls - sg.c);  // groups per block
  for (int j0 = 0; j0 < per; j0 += blockDim.x) {  // same trips in every thread
    const int j = j0 + threadIdx.x;
    const int g = sg.b * per + j;
    uint32_t v[G0];
    if (j < per) {
#pragma unroll
      for (int u = 0; u < G0; ++u) v[u] = src[g + (u << ls)];
      fwd_group<kPassLog>(v, wr, wpr, q, 1);
    }
    if (j0 == 0) cluster_wait();
    if (j < per) {
#pragma unroll
      for (int u = 0; u < G0; ++u) {
        const int e = g + (u << ls);
        cluster.map_shared_rank(s, e >> sg.logl)[swz(e & (sg.L - 1))] = v[u];
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // The other stages, segment-local: full passes, then the last pass (1
  // to 3 stages; its groups are contiguous) straight to device memory.
  const int top = sg.C + sg.b;
  int s0 = kPassLog - sg.c;
  const int tail = (sg.logl - s0) % kPassLog;
  const int last = tail ? tail : kPassLog;
  for (; s0 + last < sg.logl; s0 += kPassLog)
    ntt_fwd_pass<kPassLog>(s, wr, wpr, q, sg.logl, s0, top);
  uint32_t* dst = out + sg.row + ((size_t)sg.b << sg.logl);
  if (last == 1) fwd_store_pass<1>(s, dst, wr, wpr, q, sg.L, top << s0);
  if (last == 2) fwd_store_pass<2>(s, dst, wr, wpr, q, sg.L, top << s0);
  if (last == 3) fwd_store_pass<3>(s, dst, wr, wpr, q, sg.L, top << s0);
}

__global__ void __launch_bounds__(1024)
    ntt_inv_kernel(const uint32_t* __restrict__ in,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ w,
                   const uint32_t* __restrict__ wp,
                   const uint32_t* __restrict__ qs,
                   const uint32_t* __restrict__ ninv,
                   const uint32_t* __restrict__ ninvp, int n_sub, int logn) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const Seg sg(cluster, n_sub, logn);
  const uint32_t q = qs[sg.p];
  const uint32_t* wr = w + ((size_t)sg.p << logn);
  const uint32_t* wpr = wp + ((size_t)sg.p << logn);
  const int top = sg.C + sg.b;

  // The first log2 N - 3 stages, segment-local. The first pass loads its
  // contiguous groups of 8 from device memory as 16-byte words.
  const uint32_t* src = in + sg.row + ((size_t)sg.b << sg.logl);
  for (int g = threadIdx.x; g < (sg.L >> kPassLog); g += blockDim.x) {
    uint32_t v[1 << kPassLog];
    const uint4* d = reinterpret_cast<const uint4*>(src + (g << kPassLog));
#pragma unroll
    for (int u = 0; u < (1 << kPassLog); u += 4) {
      const uint4 x = d[u / 4];
      v[u] = x.x;
      v[u + 1] = x.y;
      v[u + 2] = x.z;
      v[u + 3] = x.w;
    }
    inv_group<kPassLog>(v, wr, wpr, q,
                        (top << (sg.logl - kPassLog)) + g, false, 0, 0);
#pragma unroll
    for (int u = 0; u < (1 << kPassLog); ++u)
      s[swz((g << kPassLog) + u)] = v[u];
  }
  __syncthreads();
  // The short pass, if any, comes second: at stride 8 a pass of 3 stages
  // would put two threads of a warp on one bank, a pass of 2 does not.
  const int ls = logn - kPassLog;  // log2 S: local stages end at t = S / 2
  const int tail = (ls - kPassLog) % kPassLog;
  if (tail == 2)
    ntt_inv_pass<2>(s, wr, wpr, q, 0, 0, sg.logl, kPassLog, top, false);
  if (tail == 1)
    ntt_inv_pass<1>(s, wr, wpr, q, 0, 0, sg.logl, kPassLog, top, false);
  for (int s0 = kPassLog + tail; s0 < ls; s0 += kPassLog)
    ntt_inv_pass<kPassLog>(s, wr, wpr, q, 0, 0, sg.logl, s0, top, false);

  // The last 3 stages on the S-strided groups, read through DSMEM once
  // every segment is done, N^-1 folded into the final stage.
  cluster_arrive();
  cluster_wait();
  constexpr int G0 = 1 << kPassLog;
  const int per = 1 << (ls - sg.c);
  const uint32_t nv = ninv[sg.p], nvp = ninvp[sg.p];
  uint32_t* dst = out + sg.row;
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    const int g = sg.b * per + j;
    uint32_t v[G0];
#pragma unroll
    for (int u = 0; u < G0; ++u) {
      const int e = g + (u << ls);
      v[u] = cluster.map_shared_rank(s, e >> sg.logl)[swz(e & (sg.L - 1))];
    }
    inv_group<kPassLog>(v, wr, wpr, q, 1, true, nv, nvp);
#pragma unroll
    for (int u = 0; u < G0; ++u) dst[g + (u << ls)] = v[u];
  }
  // No block exits while another may still read its shared memory.
  cluster_arrive();
  cluster_wait();
}

const void* kernel(bool inv) {
  return inv ? (const void*)ntt_inv_kernel : (const void*)ntt_fwd_kernel;
}

// Whether a ring of 2^logn splits into 2^c segments, and the threads per
// block then (0 when it does not).
int seg_threads(int logn, int c) {
  if (logn < kMinLogN || logn > kMaxLogN || c < 0 || c > kMaxClusterLog ||
      logn - c < kMinSegLog)
    return 0;
  const int t = 1 << (logn - c - kPassLog);
  return t < 1024 ? t : 1024;
}

// A launch of `rows` rows in clusters of 2^c blocks.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;

  Launch(int logn, int c, int rows, cudaStream_t stream) : cfg(), attr() {
    cfg.gridDim = dim3(rows << c);
    cfg.blockDim = dim3(seg_threads(logn, c));
    cfg.dynamicSmemBytes = sizeof(uint32_t) << (logn - c);
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1 << c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  Launch(const Launch&) = delete;
};

// How many clusters of 2^c blocks of the forward (inv false) or inverse
// kernel the device holds at once, asked once per ring size and kept.
cudaError_t clusters_held(bool inv, int logn, int c, int* count) {
  static int held[2][kMaxLogN + 1][kMaxClusterLog + 1];  // count + 1
  int& h = held[inv][logn][c];
  if (h == 0) {
    Launch l(logn, c, 1, nullptr);
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&h, kernel(inv), &l.cfg);
    if (err != cudaSuccess) {
      h = 0;
      return err;
    }
    ++h;
  }
  *count = h - 1;
  return cudaSuccess;
}

// The cluster size 2^c of a launch: the largest the ring splits into
// (segments of >= 1024 words, C <= 8) of which the card holds a cluster,
// whatever the row count. More, shorter segments spread a row over more
// SMs and balance the blocks better; over 2 to 52 rows at N = 16384 each
// halving of C was slower (PERF.md).
cudaError_t choose_cluster(bool inv, int logn, int* c_out) {
  for (int c = kMaxClusterLog; c >= 0; --c) {
    int count;
    if (seg_threads(logn, c) == 0) continue;
    const cudaError_t err = clusters_held(inv, logn, c, &count);
    if (err != cudaSuccess) return err;
    if (count > 0) {
      *c_out = c;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

// The cluster size of a launch: `cluster` if it is > 0 (a power of two the
// ring splits into and the card holds), else the chooser's.
cudaError_t launch_cluster(bool inv, int logn, int cluster, int* c) {
  if (cluster <= 0) return choose_cluster(inv, logn, c);
  *c = __builtin_ctz(cluster);
  int count;
  if (cluster & (cluster - 1) || seg_threads(logn, *c) == 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = clusters_held(inv, logn, *c, &count);
  if (err != cudaSuccess) return err;
  return count > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// Opt both kernels in to one segment's dynamic shared memory at the
// largest ring (128 KB, above the 48 KB default) on the current device.
int eva_ntt_init() {
  for (int inv = 0; inv < 2; ++inv) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel(inv), cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRowSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Resource use at a ring of 2^logn, for reports: out[0..3] = registers per
// thread and local (spill) bytes per thread of the forward and inverse
// kernels; out[4], out[5] = the cluster sizes they take; for c = 0 .. 3,
// out[6 + 3c] = threads per block of a cluster of 2^c (0: the ring does
// not split so), out[7 + 3c] and out[8 + 3c] = the clusters of 2^c
// forward and inverse blocks the device holds at once.
int eva_ntt_info(int logn, int* out) {
  if (logn < kMinLogN || logn > kMaxLogN) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  for (int inv = 0; inv < 2; ++inv) {
    cudaFuncAttributes attr;
    int c;
    if ((err = cudaFuncGetAttributes(&attr, kernel(inv))) != cudaSuccess ||
        (err = choose_cluster(inv, logn, &c)) != cudaSuccess)
      return (int)err;
    out[2 * inv] = attr.numRegs;
    out[2 * inv + 1] = (int)attr.localSizeBytes;
    out[4 + inv] = 1 << c;
  }
  for (int c = 0; c <= kMaxClusterLog; ++c) {
    out[6 + 3 * c] = seg_threads(logn, c);
    out[7 + 3 * c] = out[8 + 3 * c] = 0;
    for (int inv = 0; inv < 2 && out[6 + 3 * c]; ++inv)
      if ((err = clusters_held(inv, logn, c, &out[7 + 3 * c + inv])) !=
          cudaSuccess)
        return (int)err;
  }
  return 0;
}

// Forward NTT of `rows` rows of length 2^logn in clusters of `cluster`
// blocks (0: chosen by the kernel); returns the cudaError_t of the launch
// (0 on success).
int eva_ntt_fwd(const void* in, void* out, const void* w, const void* wp,
                const void* q, int rows, int n_sub, int logn, int cluster,
                void* stream) {
  if (rows <= 0 || rows > kMaxRows || n_sub <= 0 ||
      seg_threads(logn, 0) == 0)
    return (int)cudaErrorInvalidValue;
  int c;
  cudaError_t err = launch_cluster(false, logn, cluster, &c);
  if (err != cudaSuccess) return (int)err;
  Launch l(logn, c, rows, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&l.cfg, ntt_fwd_kernel, (const uint32_t*)in,
                           (uint32_t*)out, (const uint32_t*)w,
                           (const uint32_t*)wp, (const uint32_t*)q, n_sub,
                           logn);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Inverse NTT with N^-1 folded in; same conventions as eva_ntt_fwd.
int eva_ntt_inv(const void* in, void* out, const void* w, const void* wp,
                const void* q, const void* ninv, const void* ninvp, int rows,
                int n_sub, int logn, int cluster, void* stream) {
  if (rows <= 0 || rows > kMaxRows || n_sub <= 0 ||
      seg_threads(logn, 0) == 0)
    return (int)cudaErrorInvalidValue;
  int c;
  cudaError_t err = launch_cluster(true, logn, cluster, &c);
  if (err != cudaSuccess) return (int)err;
  Launch l(logn, c, rows, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&l.cfg, ntt_inv_kernel, (const uint32_t*)in,
                           (uint32_t*)out, (const uint32_t*)w,
                           (const uint32_t*)wp, (const uint32_t*)q,
                           (const uint32_t*)ninv, (const uint32_t*)ninvp,
                           n_sub, logn);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
