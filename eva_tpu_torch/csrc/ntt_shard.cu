// The local phases of the sharded four-step NTT, for Hopper (sm_90a):
// one launch per phase of eva_tpu_torch/parallel/ntt_shard.py's
// ShardPhases, where its plain version runs one elementwise pass per
// butterfly stage.
//
// Replaces (as computations; on the TPU these are jnp stages that XLA
// fuses inside the jitted seq and dp+seq programs: no Pallas kernel stands
// behind them):
//   K6 ntt_shard_fwd  eva_tpu/parallel/ntt_shard.py ShardedNTT.ntt's two
//                     local phases: the twist, _sub_dif_rows (:132) down
//                     the lane-sharded [n1, n2/D] columns and the
//                     correction twiddle; _sub_dif_rows along the
//                     row-sharded [n1/D, n2] rows
//   K7 ntt_shard_inv  ShardedNTT.intt's: _sub_dit_rows (:153) along the
//                     row-sharded rows and the correction twiddle, stored
//                     transposed ([n2, n1/D], the all-to-all's layout);
//                     _sub_dit_rows down the columns, read from the
//                     all-to-all's [n2/D, n1], and the untwist
// Plain PyTorch versions: ShardPhases.plain_fwd_cols / plain_fwd_rows /
// plain_inv_rows / plain_inv_cols. Every step is exact modular arithmetic
// on canonical residues (ntt_common.cuh's shoup_mul_r, add_mod_r,
// sub_mod_r), so the results are the plain versions' and the JAX
// package's, bit for bit.
//
// A phase runs a sub-transform of length size (n1 = N / 128 for the
// columns, n2 = 128 for the rows) over `count` independent vectors of
// each plane (a plane: one prime of one polynomial, [size, count] or
// [count, size] words). Layout "t-major" is [size, count] (the transform
// axis outer, vectors adjacent in memory), "v-major" [count, size] (each
// vector contiguous). The optional twiddles multiplied in before the
// stages (pre) and after them (post) are [n_sub, size, count] Shoup pairs
// per prime in the input's and the output's layout. The packed stage
// twiddles st [n_sub, size] hold the stage with half-block h at [h - 1,
// 2h - 1); every block of a stage shares them.
//   forward columns  t-major in and out, pre tw_fwd, post corr_fwd, DIF
//   forward rows     v-major in and out, DIF
//   inverse rows     v-major in, t-major out, DIT, post corr_inv
//   inverse columns  v-major in, t-major out, DIT, post tw_inv
//
// One block takes V vectors of one plane (a tile of size x V words, V = 8
// to 32) into shared memory with coalesced loads, applying pre on the
// way in; runs every stage there, one butterfly per thread and step, a
// __syncthreads() between stages; and stores once, applying post on the
// way out. The tile's rows are V + 1 words apart, so a warp walking
// either axis touches distinct banks.
//
// What bounds it: at Sobel's shapes, the launch. A phase at [11, 16384]
// reads and writes 1.4 MB (0.43 us at 3.35 TB/s) plus its twiddle pairs
// (2.9 MB for the forward columns' two) and runs 7 stages of 90k
// butterflies (14 ops each: 0.53 us at 16.7e12 int32 op/s): bytes for
// the phases with twiddle tables, operations for the forward rows. The
// design keeps the data out of device memory between stages (the plain
// version moves it 2 x 7 times per phase) and makes a phase one launch
// where it was ~21.
//
// Launched with programmatic stream serialization, as modmath.cu's
// kernels: each waits (griddepcontrol.wait) for the previous grid before
// it touches device memory and lets its dependents start launching.
// A failed launch returns its error; nothing falls back.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_common.cuh"

namespace {

using eva::add_mod_r;
using eva::shoup_mul_r;
using eva::sub_mod_r;

constexpr int kThreads = 256;
constexpr int kMaxTileLog = 5;  // V <= 32 vectors a block
constexpr int kMinTileLog = 3;  // V >= 8 where the plane has them
constexpr int kMaxSizeLog = 8;  // n1 <= 256 (N = 32768)
constexpr int kWantBlocks = 264;  // two blocks per SM of the H100's 132

struct Phase {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* q;       // [n_sub]
  const uint32_t* st_w;    // [n_sub, size] packed stage twiddles
  const uint32_t* st_wp;
  const uint32_t* pre_w;   // [n_sub, size, count] in the input's layout,
  const uint32_t* pre_wp;  // or null
  const uint32_t* post_w;  // the same in the output's layout, or null
  const uint32_t* post_wp;
  int n_sub, log_size, log_count, log_tile;
};

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Word offset, within its plane, of element t of vector v in a t-major
// ([size, count]) or v-major ([count, size]) plane.
template <bool kTMajor>
__device__ __forceinline__ int plane_offset(int t, int v, int log_size,
                                            int log_count) {
  return kTMajor ? (t << log_count) + v : (v << log_size) + t;
}

// Element e of a tile of V vectors in the order that walks the plane's
// contiguous axis fastest: (t, v), v relative to the tile.
template <bool kTMajor>
__device__ __forceinline__ void tile_coords(int e, int log_size,
                                            int log_tile, int& t, int& v) {
  if (kTMajor) {
    t = e >> log_tile;
    v = e & ((1 << log_tile) - 1);
  } else {
    v = e >> log_size;
    t = e & ((1 << log_size) - 1);
  }
}

// One phase: grid (planes * count / V), one block per tile of V vectors
// of one plane. kDif: the forward sub-DIF (natural in, bit-reversed out),
// else the inverse sub-DIT; kInT / kOutT: the input / output plane is
// t-major.
template <bool kDif, bool kInT, bool kOutT>
__global__ void __launch_bounds__(kThreads)
    ntt_shard_kernel(const __grid_constant__ Phase P) {
  extern __shared__ uint32_t smem[];
  const int log_size = P.log_size, log_tile = P.log_tile;
  const int size = 1 << log_size, pitch = (1 << log_tile) + 1;
  const int tiles_log = P.log_count - log_tile;
  const long long plane = blockIdx.x >> tiles_log;
  const int v0 = (blockIdx.x & ((1 << tiles_log) - 1)) << log_tile;
  const int p = (int)(plane % P.n_sub);
  const long long words = (long long)size << P.log_count;
  uint32_t* tw = smem + size * pitch;
  uint32_t* twp = tw + size;

  wait_prior_grid();
  launch_dependents();
  const uint32_t q = P.q[p];
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    tw[i] = P.st_w[p * size + i];
    twp[i] = P.st_wp[p * size + i];
  }
  const int elems = size << log_tile;
  {
    const uint32_t* x = P.x + plane * words;
    const uint32_t *pw = nullptr, *pwp = nullptr;
    if (P.pre_w) {
      pw = P.pre_w + p * words;
      pwp = P.pre_wp + p * words;
    }
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      int t, v;
      tile_coords<kInT>(e, log_size, log_tile, t, v);
      const int off = plane_offset<kInT>(t, v0 + v, log_size, P.log_count);
      uint32_t a = x[off];
      if (pw) a = shoup_mul_r(a, __ldg(pw + off), __ldg(pwp + off), q);
      smem[t * pitch + v] = a;
    }
  }
  __syncthreads();

  // Stage with half-block h: pair i (< size / 2) of vector v joins
  // element blk * 2h + j with the one h after it, blk = i / h, j = i % h,
  // and takes the twiddle at h - 1 + j.
  const int pairs = elems >> 1;
  for (int h = kDif ? size >> 1 : 1; kDif ? h >= 1 : h < size;
       h = kDif ? h >> 1 : h << 1) {
    for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
      const int v = k & ((1 << log_tile) - 1), i = k >> log_tile;
      const int j = i & (h - 1);
      uint32_t* lo = smem + (2 * i - j) * pitch + v;
      uint32_t* hi = lo + h * pitch;
      const uint32_t w = tw[h - 1 + j], wp = twp[h - 1 + j];
      const uint32_t a = *lo;
      if (kDif) {
        const uint32_t b = *hi;
        *lo = add_mod_r(a, b, q);
        *hi = shoup_mul_r(sub_mod_r(a, b, q), w, wp, q);
      } else {
        const uint32_t b = shoup_mul_r(*hi, w, wp, q);
        *lo = add_mod_r(a, b, q);
        *hi = sub_mod_r(a, b, q);
      }
    }
    __syncthreads();
  }

  uint32_t* out = P.out + plane * words;
  const uint32_t *pw = nullptr, *pwp = nullptr;
  if (P.post_w) {
    pw = P.post_w + p * words;
    pwp = P.post_wp + p * words;
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    int t, v;
    tile_coords<kOutT>(e, log_size, log_tile, t, v);
    const int off = plane_offset<kOutT>(t, v0 + v, log_size, P.log_count);
    uint32_t a = smem[t * pitch + v];
    if (pw) a = shoup_mul_r(a, __ldg(pw + off), __ldg(pwp + off), q);
    out[off] = a;
  }
}

// The three forms a phase takes (see the header): forward columns,
// forward rows, and both inverse phases.
enum Form { kFwdCols = 0, kFwdRows = 1, kInv = 2, kForms = 3 };

const void* kernel_of(int form) {
  switch (form) {
    case kFwdCols:
      return (const void*)ntt_shard_kernel<true, true, true>;
    case kFwdRows:
      return (const void*)ntt_shard_kernel<true, false, false>;
    default:
      return (const void*)ntt_shard_kernel<false, false, true>;
  }
}

// The vectors a block takes: 32 where the grid still has kWantBlocks
// blocks, down to 8 (or the plane's count, if fewer) to reach it.
int tile_log(long long planes, int log_count) {
  int lt = log_count < kMaxTileLog ? log_count : kMaxTileLog;
  while (lt > kMinTileLog && (planes << (log_count - lt)) < kWantBlocks) --lt;
  return lt;
}

}  // namespace

extern "C" {

// One phase of `form` (0: forward columns, 1: forward rows, 2: either
// inverse phase) over `planes` contiguous planes of 2^log_size x
// 2^log_count words; plane r uses prime r % n_sub of q and of the tables.
// pre_* / post_* may be null (no multiply). Returns the launch's
// cudaError_t.
int eva_ntt_shard(int form, const void* x, void* out, const void* q,
                  const void* st_w, const void* st_wp, const void* pre_w,
                  const void* pre_wp, const void* post_w,
                  const void* post_wp, long long planes, int n_sub,
                  int log_size, int log_count, void* stream) {
  if (form < 0 || form >= kForms || planes <= 0 || n_sub <= 0 ||
      planes % n_sub || log_size < 1 || log_size > kMaxSizeLog ||
      log_count < 0 || log_size + log_count > 20)
    return (int)cudaErrorInvalidValue;
  Phase P;
  P.x = (const uint32_t*)x;
  P.out = (uint32_t*)out;
  P.q = (const uint32_t*)q;
  P.st_w = (const uint32_t*)st_w;
  P.st_wp = (const uint32_t*)st_wp;
  P.pre_w = (const uint32_t*)pre_w;
  P.pre_wp = (const uint32_t*)pre_wp;
  P.post_w = (const uint32_t*)post_w;
  P.post_wp = (const uint32_t*)post_wp;
  P.n_sub = n_sub;
  P.log_size = log_size;
  P.log_count = log_count;
  P.log_tile = tile_log(planes, log_count);
  const long long blocks = planes << (log_count - P.log_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int elems = 1 << (log_size + P.log_tile);
  const int threads = elems / 2 < kThreads ? (elems / 2 < 32 ? 32 : elems / 2)
                                           : kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes =
      ((1 << log_size) * ((1 << P.log_tile) + 1) + 2 * (1 << log_size)) *
      sizeof(uint32_t);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {&P};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_of(form), args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resource use, for reports: out[2f], out[2f + 1] = registers and local
// (spill) bytes per thread of form f (forward columns, forward rows,
// inverse). Returns 0 or a cudaError_t.
int eva_ntt_shard_info(int* out) {
  for (int f = 0; f < kForms; ++f) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(f));
    if (err != cudaSuccess) return (int)err;
    out[2 * f] = attr.numRegs;
    out[2 * f + 1] = (int)attr.localSizeBytes;
  }
  return 0;
}

}  // extern "C"
