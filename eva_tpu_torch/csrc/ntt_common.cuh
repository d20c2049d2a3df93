// The register-radix negacyclic NTT, and the 32-bit modular arithmetic
// under it, for Hopper (sm_90a). Included by ntt.cu (the NTT kernels) and
// ks.cu (the fused key-switch kernels: the MAC's whole row in one block,
// ntt_fwd_row; the epilogue's rows split over a thread-block cluster, as
// ntt.cu's, through the cluster passes at the end of this file). Both run
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace eva {

namespace cg = cooperative_groups;

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

// One inverse pass, as ntt_fwd_pass (never the transform's final stage:
// that runs on the S-strided groups, seg_inv_row).
template <int RP>
__device__ __forceinline__ void ntt_inv_pass(uint32_t* s,
                                             const uint32_t* __restrict__ wr,
                                             const uint32_t* __restrict__ wpr,
                                             uint32_t q, int logn, int s0,
                                             int top) {
  constexpr int G = 1 << RP;
  const int lt = s0;
  const int groups = 1 << (logn - RP);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int outer = g >> lt;
    const int base = (outer << (lt + RP)) + (g & ((1 << lt) - 1));
    uint32_t v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = s[swz(base + (u << lt))];
    inv_group<RP>(v, wr, wpr, q, (top << (logn - s0 - RP)) + outer, false,
                  0, 0);
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

// Threads per block of a segment of 2^(logn - c) words (a row cut into
// 2^c): 8 words per thread per pass, at most 1024; 0 when the ring is out
// of range or the segment would be shorter than 2^kMinSegLog words.
// seg_threads(logn, 0) is a whole row in one block.
constexpr int kMaxClusterLog = 3;  // C = 8: the portable cluster size
constexpr int kMinSegLog = 10;     // segments of at least 1024 words

inline int seg_threads(int logn, int c) {
  if (logn < kMinLogN || logn > kMaxLogN || c < 0 || c > kMaxClusterLog ||
      logn - c < kMinSegLog)
    return 0;
  const int t = 1 << (logn - c - kPassLog);
  return t < 1024 ? t : 1024;
}

// A row split over a thread-block cluster (ntt.cu's K1 and K2, ks.cu's
// epilogue). The row of N = 2^logn is cut into C = 2^c segments of L =
// N / C words, one per block of a cluster of C: rank b holds [b L,
// (b + 1) L) in its shared memory (4L bytes, swizzled as swz). Write
// S = N / 8. The 3 stages of the largest strides pair the S-strided
// groups {g + u S : u < 8}, across segments for log2 C of them: block b
// takes groups [b S / C, (b + 1) S / C) and reads or writes each word in
// the segment that holds it (seg_word: distributed shared memory). Every
// other stage is local to a segment: register passes whose twiddle
// blocks are led by top = C + b (see ntt_fwd_pass). The forward runs the
// strided stages first and the inverse runs them last, on the same
// groups.

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

// Where a block stands: its cluster (C = 2^c blocks, rank b) and its
// segment of L = 2^logl words.
struct Seg {
  int c, C, b, logl, L;

  __device__ Seg(cg::cluster_group& cluster, int logn) {
    C = (int)cluster.num_blocks();
    b = (int)cluster.block_rank();
    c = __ffs(C) - 1;
    logl = logn - c;
    L = 1 << logl;
  }
};

// Word e of the row, in the shared memory of the segment that holds it.
__device__ __forceinline__ uint32_t* seg_word(cg::cluster_group& cluster,
                                              uint32_t* s, const Seg& sg,
                                              int e) {
  return cluster.map_shared_rank(s, e >> sg.logl) + swz(e & (sg.L - 1));
}

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

// The forward's segment-local stages, once every segment holds its words
// after the strided stages (a cluster barrier): full passes, then the
// last pass (1 to 3 stages; its groups are contiguous) straight to this
// segment's place in the device-memory row dst_row.
__device__ __forceinline__ void seg_fwd_local(
    uint32_t* s, uint32_t* __restrict__ dst_row,
    const uint32_t* __restrict__ wr, const uint32_t* __restrict__ wpr,
    uint32_t q, const Seg& sg) {
  const int top = sg.C + sg.b;
  int s0 = kPassLog - sg.c;
  const int tail = (sg.logl - s0) % kPassLog;
  const int last = tail ? tail : kPassLog;
  for (; s0 + last < sg.logl; s0 += kPassLog)
    ntt_fwd_pass<kPassLog>(s, wr, wpr, q, sg.logl, s0, top);
  uint32_t* dst = dst_row + ((size_t)sg.b << sg.logl);
  if (last == 1) fwd_store_pass<1>(s, dst, wr, wpr, q, sg.L, top << s0);
  if (last == 2) fwd_store_pass<2>(s, dst, wr, wpr, q, sg.L, top << s0);
  if (last == 3) fwd_store_pass<3>(s, dst, wr, wpr, q, sg.L, top << s0);
}

// The inverse's first log2 N - 3 stages, segment-local, from this
// segment's place in the device-memory row src_row: the first pass loads
// its contiguous groups of 8 as 16-byte words. Returns after a
// __syncthreads(), before the strided stages.
__device__ __forceinline__ void seg_inv_local(
    uint32_t* s, const uint32_t* __restrict__ src_row,
    const uint32_t* __restrict__ wr, const uint32_t* __restrict__ wpr,
    uint32_t q, const Seg& sg, int logn) {
  const int top = sg.C + sg.b;
  const uint32_t* src = src_row + ((size_t)sg.b << sg.logl);
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
  if (tail == 2) ntt_inv_pass<2>(s, wr, wpr, q, sg.logl, kPassLog, top);
  if (tail == 1) ntt_inv_pass<1>(s, wr, wpr, q, sg.logl, kPassLog, top);
  for (int s0 = kPassLog + tail; s0 < ls; s0 += kPassLog)
    ntt_inv_pass<kPassLog>(s, wr, wpr, q, sg.logl, s0, top);
}

// A whole inverse over the cluster, src_row to dst_row: the local stages,
// a cluster barrier, then the last 3 stages on this block's S-strided
// groups read through distributed shared memory, N^-1 (the Shoup pair
// *nv, *nvp, read after the barrier) folded into the final stage, stored
// to dst_row. A closing cluster barrier keeps every block's shared memory
// alive until the others have read it.
__device__ __forceinline__ void seg_inv_row(
    cg::cluster_group& cluster, uint32_t* s,
    const uint32_t* __restrict__ src_row, uint32_t* __restrict__ dst_row,
    const uint32_t* __restrict__ wr, const uint32_t* __restrict__ wpr,
    uint32_t q, const uint32_t* nv, const uint32_t* nvp, const Seg& sg,
    int logn) {
  seg_inv_local(s, src_row, wr, wpr, q, sg, logn);
  cluster_arrive();
  cluster_wait();
  const uint32_t nv0 = *nv, nvp0 = *nvp;
  constexpr int G0 = 1 << kPassLog;
  const int ls = logn - kPassLog;
  const int per = 1 << (ls - sg.c);
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    const int g = sg.b * per + j;
    uint32_t v[G0];
#pragma unroll
    for (int u = 0; u < G0; ++u)
      v[u] = *seg_word(cluster, s, sg, g + (u << ls));
    inv_group<kPassLog>(v, wr, wpr, q, 1, true, nv0, nvp0);
#pragma unroll
    for (int u = 0; u < G0; ++u) dst_row[g + (u << ls)] = v[u];
  }
  // No block exits while another may still read its shared memory.
  cluster_arrive();
  cluster_wait();
}

// A launch of a grid in thread-block clusters of C blocks along x
// (cudaLaunchKernelEx); with pdl, as the programmatic dependent of the
// grid before it on the stream (it may start once every block of that
// grid has run griddepcontrol.launch_dependents).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];

  ClusterLaunch(dim3 grid, int threads, size_t smem, int C,
                cudaStream_t stream, bool pdl = false)
      : cfg(), attr() {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Dynamic shared memory of one row at the largest ring (128 KB), above
// the 48 KB default: each kernel is opted in once per device.
constexpr int kRowSmemMax = (1 << kMaxLogN) * (int)sizeof(uint32_t);

}  // namespace eva
