// Elementwise modular arithmetic over 32-bit RNS limb planes, for Hopper
// (sm_90a): the ops the JAX package leaves to XLA to fuse around its
// Pallas kernels.
//
// Replaces (as computations; on the TPU these are jnp expressions that
// XLA fuses into the jitted program, next to the Pallas kernels):
//   E1 mod_ew          eva_tpu/backend/modmath.py  add_mod, sub_mod,
//                      neg_mod, mont_mul (_mul32), shoup_mul; and
//                      eva_tpu/backend/tables.py DeviceLevelOps.mul
//                      (two Montgomery steps) and reduce (Shoup by 1)
//   E2 tensor_product  eva_tpu/backend/tables.py
//                      DeviceLevelOps.tensor_product (Karatsuba, 5
//                      Montgomery multiplies)
//   E3 divide_last     eva_tpu/backend/executor_jax.py divide_last_planes
//                      (the rescale's divide-and-round by the last prime)
// Plain PyTorch versions: eva_tpu_torch/backend/modmath.py (E1, E2) and
// backend/ks.py divide_last_planes (E3). Every formula is the JAX
// package's, written literally (a compare and select where it has
// jnp.where), so the results are its uint32 results bit for bit, for
// every input it accepts (unreduced first operands up to 2^32 for the
// Montgomery and Shoup multiplies).
//
// Layout: residues are uint32 words (int32 tensors carrying the uint32
// bit pattern). The output is a contiguous [..., n_sub, n] plane; row r of
// its flattened leading dims uses prime r % n_sub (E1 may take its primes
// from an earlier dim, [..., n_sub, a, .., n]: then row r uses prime
// (r / inner) % n_sub, inner the product of the dims after the primes'
// but the last; the four-step NTT of parallel/ntt_shard.py runs so). Each
// operand is contiguous in its own shape and broadcast against the output
// by shape (size-1 dims): the wrapper passes, for the output's leading dims
// (coalesced, at most kMaxDims), their sizes and each operand's strides in
// words (0 where it broadcasts), and each operand's stride along the last
// dim (1, or 0 for a per-row constant [n_sub, 1]). One block per output
// row and column chunk (blockIdx.x = row, so batches of any size fit the
// grid); a block finds its operands' row offsets once and its threads walk
// the row's columns.
//
// What bounds them on this card: bytes. A modular multiply is ~9 32-bit
// integer operations per word against 12 bytes moved (two reads, one
// write): 0.75 ops a byte, where the H100 does ~5 (16.7e12 int32 op/s over
// 3.35 TB/s). At Sobel's level 0, a dyadic op over [12, 16384] moves 2.4 MB
// (0.7 us at 3.35 TB/s); E2 moves 4 planes in and 3 out, E3 one plane in
// and one out. So the design is one pass per operation, every
// intermediate in registers (E2 keeps its 5 products there; E3 its
// unreduced sum), nothing allocated in the kernel. The launch, not the
// bytes, is what a call at batch 1 pays: each op is one launch where the
// int64 version took 4-8 PyTorch kernels. A failed launch returns its
// error; nothing falls back.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDims = 8;   // leading dims of the output, coalesced
constexpr int kOperands = 3;  // a, b, c (E2: a-side, b-side)
constexpr int kThreads = 256;
constexpr int kMaxChunks = 64;  // column chunks of a row (grid y)

// The output's leading dims and each operand's strides along them (words;
// 0 where the operand broadcasts), its stride along the last dim, the
// last dim's length, the number of primes, and the rows each prime's
// index repeats for (1 when the primes are the second-last dim).
struct Shape {
  int ndim, n, n_sub, inner;
  int size[kMaxDims];
  long long stride[kOperands][kMaxDims];
  long long last[kOperands];
};

// The JAX package's formulas (eva_tpu/backend/modmath.py), literally.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

__device__ __forceinline__ uint32_t neg_mod(uint32_t a, uint32_t q) {
  return a == 0 ? a : q - a;
}

// a * b * 2^-32 mod q (b = b' * 2^32 mod q, Montgomery form), for any
// a < 2^32 and b < q: t + m q < 2^64 and u = (t + m q) / 2^32 < 2q. The
// canonical residue, as the JAX package's mont_mul (its _mul32 split
// products compute the same u).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t nqinv) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * nqinv;
  const uint32_t u = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return u >= q ? u - q : u;
}

// a * w mod q for w < q, wp = floor(w 2^32 / q), any a < 2^32: the
// precomputed-quotient multiply of the JAX package's shoup_mul.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t wp, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, wp) * q;
  return r >= q ? r - q : r;
}

enum Op { kAdd = 0, kSub, kNeg, kMontMul, kMul, kShoup, kNumOps };

// The row offsets of the operands of output row `row` (flattened over the
// leading dims), walking the dims innermost first.
__device__ __forceinline__ void row_offsets(const Shape& sh, int row,
                                            long long (&off)[kOperands]) {
#pragma unroll
  for (int k = 0; k < kOperands; ++k) off[k] = 0;
  for (int d = sh.ndim - 1; d >= 0; --d) {
    const int i = row % sh.size[d];
    row /= sh.size[d];
#pragma unroll
    for (int k = 0; k < kOperands; ++k) off[k] += i * sh.stride[k][d];
  }
}

// E1: out = OP(a, b, c) per word. b is unused by kNeg, c is r2 (R^2 mod q,
// per row) for kMul and wp for kShoup.
template <int OP>
__global__ void __launch_bounds__(kThreads)
    mod_ew_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b,
                  const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ qs,
                  const uint32_t* __restrict__ nqinvs, Shape sh) {
  const int row = blockIdx.x;
  long long off[kOperands];
  row_offsets(sh, row, off);
  const int p = row / sh.inner % sh.n_sub;
  const uint32_t q = qs[p];
  const uint32_t nqinv = nqinvs[p];
  uint32_t* dst = out + (size_t)row * sh.n;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < sh.n;
       e += gridDim.y * blockDim.x) {
    const uint32_t x = a[off[0] + e * sh.last[0]];
    uint32_t v;
    if (OP == kAdd) {
      v = add_mod(x, b[off[1] + e * sh.last[1]], q);
    } else if (OP == kSub) {
      v = sub_mod(x, b[off[1] + e * sh.last[1]], q);
    } else if (OP == kNeg) {
      v = neg_mod(x, q);
    } else if (OP == kMontMul) {
      v = mont_mul(x, b[off[1] + e * sh.last[1]], q, nqinv);
    } else if (OP == kMul) {
      v = mont_mul(mont_mul(x, b[off[1] + e * sh.last[1]], q, nqinv),
                   c[off[2] + e * sh.last[2]], q, nqinv);
    } else {
      v = shoup_mul(x, b[off[1] + e * sh.last[1]],
                    c[off[2] + e * sh.last[2]], q);
    }
    dst[e] = v;
  }
}

// E2: the ciphertext tensor product (a0, a1) x (b0, b1) -> (d0, d1, d2),
// Karatsuba with a one-time Montgomery conversion of the a-side: 5
// Montgomery multiplies (eva_tpu/backend/tables.py tensor_product). a0
// and a1 share operand slot 0's strides, b0 and b1 slot 1's; r2 is per
// prime.
__global__ void __launch_bounds__(kThreads)
    tensor_product_kernel(const uint32_t* __restrict__ a0,
                          const uint32_t* __restrict__ a1,
                          const uint32_t* __restrict__ b0,
                          const uint32_t* __restrict__ b1,
                          uint32_t* __restrict__ d0, uint32_t* __restrict__ d1,
                          uint32_t* __restrict__ d2,
                          const uint32_t* __restrict__ qs,
                          const uint32_t* __restrict__ nqinvs,
                          const uint32_t* __restrict__ r2s, Shape sh) {
  const int row = blockIdx.x;
  long long off[kOperands];
  row_offsets(sh, row, off);
  const int p = row % sh.n_sub;
  const uint32_t q = qs[p], nqinv = nqinvs[p], r2 = r2s[p];
  const size_t o = (size_t)row * sh.n;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < sh.n;
       e += gridDim.y * blockDim.x) {
    const long long ia = off[0] + e * sh.last[0];
    const long long ib = off[1] + e * sh.last[1];
    const uint32_t a0m = mont_mul(a0[ia], r2, q, nqinv);  // a0 R mod q
    const uint32_t a1m = mont_mul(a1[ia], r2, q, nqinv);
    const uint32_t x0 = b0[ib], x1 = b1[ib];
    const uint32_t am_sum = add_mod(a0m, a1m, q);
    const uint32_t b_sum = add_mod(x0, x1, q);
    const uint32_t p0 = mont_mul(x0, a0m, q, nqinv);       // a0 b0
    const uint32_t p2 = mont_mul(x1, a1m, q, nqinv);       // a1 b1
    const uint32_t pm = mont_mul(b_sum, am_sum, q, nqinv);
    d0[o + e] = p0;
    d1[o + e] = sub_mod(sub_mod(pm, p0, q), p2, q);
    d2[o + e] = p2;
  }
}

// E3: divide-and-round of [L, n, N] coefficient planes by their last prime
// p into [L, n - 1, N]: r_i = mont_mul(x_i + p - lift, p^-1 R mod q_i)
// minus 1 when lift <= p / 2 (lift = the last row; x_i + p - lift < 2^32,
// no wrap). One block per (l, output row i) and column chunk.
__global__ void __launch_bounds__(kThreads)
    divide_last_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ qs,
                       const uint32_t* __restrict__ nqinvs,
                       const uint32_t* __restrict__ pinv, uint32_t p,
                       int n_rows, int n) {
  const int n_out = n_rows - 1;
  const int i = blockIdx.x % n_out;
  const int l = blockIdx.x / n_out;
  const uint32_t q = qs[i], nqinv = nqinvs[i], w = pinv[i];
  const uint32_t half = p / 2;
  const uint32_t* src = x + (size_t)l * n_rows * n;
  const uint32_t* lift_row = src + (size_t)n_out * n;
  src += (size_t)i * n;
  uint32_t* dst = out + (size_t)blockIdx.x * n;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < n;
       e += gridDim.y * blockDim.x) {
    const uint32_t lift = lift_row[e];
    const uint32_t r = mont_mul(src[e] + (p - lift), w, q, nqinv);
    dst[e] = sub_mod(r, lift > half ? 0u : 1u, q);
  }
}

using EwKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                          uint32_t*, const uint32_t*, const uint32_t*, Shape);

EwKernel ew_kernel(int op) {
  switch (op) {
    case kAdd: return mod_ew_kernel<kAdd>;
    case kSub: return mod_ew_kernel<kSub>;
    case kNeg: return mod_ew_kernel<kNeg>;
    case kMontMul: return mod_ew_kernel<kMontMul>;
    case kMul: return mod_ew_kernel<kMul>;
    case kShoup: return mod_ew_kernel<kShoup>;
    default: return nullptr;
  }
}

// The grid of `rows` rows of n words: one block per row and column chunk
// of kThreads words, at most kMaxChunks chunks (threads then walk the
// row with a stride).
dim3 grid(long long rows, int n) {
  int chunks = (n + kThreads - 1) / kThreads;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return dim3((unsigned)rows, (unsigned)chunks);
}

// The Shape of a call from its host description: dims[0 .. ndim) sizes,
// then for each operand k its ndim strides at dims[ndim (1 + k) ..], then
// the operands' last-dim strides. Returns false when it does not fit.
bool make_shape(int ndim, int n, int n_sub, int inner, const long long* dims,
                Shape* sh, long long* rows) {
  if (ndim < 0 || ndim > kMaxDims || n <= 0 || n_sub <= 0 || inner <= 0)
    return false;
  *sh = Shape{};
  sh->ndim = ndim;
  sh->n = n;
  sh->n_sub = n_sub;
  sh->inner = inner;
  *rows = 1;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0) return false;
    sh->size[d] = (int)dims[d];
    *rows *= dims[d];
    for (int k = 0; k < kOperands; ++k)
      sh->stride[k][d] = dims[ndim * (1 + k) + d];
  }
  for (int k = 0; k < kOperands; ++k)
    sh->last[k] = dims[ndim * (1 + kOperands) + k];
  return *rows > 0 && *rows <= 0x7fffffffLL &&
         *rows % ((long long)n_sub * inner) == 0;
}

}  // namespace

extern "C" {

// E1: out = op(a, b, c) over the broadcast shape described by dims (see
// make_shape), prime (row / inner) % n_sub for flattened row `row`; b and
// c may be null where the op does not read them. Returns the launch's
// cudaError_t (0 on success).
int eva_mod_ew(int op, const void* a, const void* b, const void* c,
               void* out, const void* q, const void* nqinv, int ndim,
               int n, int n_sub, int inner, const long long* dims,
               void* stream) {
  const EwKernel kernel = ew_kernel(op);
  Shape sh;
  long long rows;
  if (kernel == nullptr ||
      !make_shape(ndim, n, n_sub, inner, dims, &sh, &rows))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid(rows, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (uint32_t*)out, (const uint32_t*)q, (const uint32_t*)nqinv, sh);
  return (int)cudaGetLastError();
}

// E2: (d0, d1, d2) = tensor product of (a0, a1) and (b0, b1) over the
// broadcast shape dims (operand slot 0: the a-side, 1: the b-side).
int eva_tensor_product(const void* a0, const void* a1, const void* b0,
                       const void* b1, void* d0, void* d1, void* d2,
                       const void* q, const void* nqinv, const void* r2,
                       int ndim, int n, int n_sub, const long long* dims,
                       void* stream) {
  Shape sh;
  long long rows;
  if (!make_shape(ndim, n, n_sub, 1, dims, &sh, &rows))
    return (int)cudaErrorInvalidValue;
  tensor_product_kernel<<<grid(rows, n), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)a0, (const uint32_t*)a1, (const uint32_t*)b0,
      (const uint32_t*)b1, (uint32_t*)d0, (uint32_t*)d1, (uint32_t*)d2,
      (const uint32_t*)q, (const uint32_t*)nqinv, (const uint32_t*)r2, sh);
  return (int)cudaGetLastError();
}

// E3: out [lead, n_rows - 1, n] = x [lead, n_rows, n] divided by its last
// prime p (q, nqinv, pinv: the n_rows - 1 remaining primes' tables).
int eva_divide_last(const void* x, void* out, const void* q,
                    const void* nqinv, const void* pinv, unsigned p,
                    int lead, int n_rows, int n, void* stream) {
  const long long rows = (long long)lead * (n_rows - 1);
  if (lead <= 0 || n_rows < 2 || n <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  divide_last_kernel<<<grid(rows, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)q,
      (const uint32_t*)nqinv, (const uint32_t*)pinv, (uint32_t)p, n_rows, n);
  return (int)cudaGetLastError();
}

// Resource use, for reports: out[2k], out[2k + 1] = registers and local
// (spill) bytes per thread of E1 op k (k < 6), then of E2 and E3.
int eva_modmath_info(int* out) {
  const void* fns[kNumOps + 2];
  for (int k = 0; k < kNumOps; ++k) fns[k] = (const void*)ew_kernel(k);
  fns[kNumOps] = (const void*)tensor_product_kernel;
  fns[kNumOps + 1] = (const void*)divide_last_kernel;
  for (int k = 0; k < kNumOps + 2; ++k) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fns[k]);
    if (err != cudaSuccess) return (int)err;
    out[2 * k] = attr.numRegs;
    out[2 * k + 1] = (int)attr.localSizeBytes;
  }
  return 0;
}

}  // extern "C"
