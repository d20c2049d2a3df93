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
// The segment passes live in ntt_common.cuh (seg_fwd_local, seg_inv_row),
// which ks.cu's epilogue shares.
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

namespace {

using namespace eva;

constexpr int kMaxRows = 1 << 27;  // rows * 8 blocks fit the grid

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
  const Seg sg(cluster, logn);
  const int r = blockIdx.x >> sg.c;
  const int p = r % n_sub;
  const size_t row = (size_t)r << logn;
  const uint32_t q = qs[p];
  const uint32_t* wr = w + ((size_t)p << logn);
  const uint32_t* wpr = wp + ((size_t)p << logn);
  const uint32_t* src = in + row;

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
      for (int u = 0; u < G0; ++u)
        *seg_word(cluster, s, sg, g + (u << ls)) = v[u];
    }
  }
  cluster_arrive();
  cluster_wait();

  // The other stages, segment-local, the last straight to device memory.
  seg_fwd_local(s, out + row, wr, wpr, q, sg);
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
  const Seg sg(cluster, logn);
  const int r = blockIdx.x >> sg.c;
  const int p = r % n_sub;
  const size_t row = (size_t)r << logn;
  seg_inv_row(cluster, s, in + row, out + row, w + ((size_t)p << logn),
              wp + ((size_t)p << logn), qs[p], ninv + p, ninvp + p, sg, logn);
}

const void* kernel(bool inv) {
  return inv ? (const void*)ntt_inv_kernel : (const void*)ntt_fwd_kernel;
}

// A launch of `rows` rows in clusters of 2^c blocks.
struct Launch : ClusterLaunch {
  Launch(int logn, int c, int rows, cudaStream_t stream)
      : ClusterLaunch(dim3(rows << c), seg_threads(logn, c),
                      sizeof(uint32_t) << (logn - c), 1 << c, stream) {}
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
