// Elementwise modular arithmetic over 32-bit RNS limb planes, for Hopper
// (sm_90a): the ops the JAX package leaves to XLA to fuse around its
// Pallas kernels.
//
// Replaces (as computations; on the TPU these are jnp expressions that
// XLA fuses into the jitted program, next to the Pallas kernels):
//   E1 mod_ew          eva_tpu/backend/modmath.py  add_mod, sub_mod,
//                      neg_mod, mont_mul (_mul32), shoup_mul; and
//                      eva_tpu/backend/tables.py DeviceLevelOps.mul
//                      (two Montgomery steps) and reduce (Shoup by 1).
//                      Three forms: one op on one plane (mod_ew_kernel);
//                      one op on 2-4 independent planes in one launch
//                      (mod_ew_multi_kernel: a rotation sum's c0, c1,
//                      acc0, acc1; a ciphertext's components); and the
//                      structured key-switch MAC (mod_ew_mac_kernel:
//                      eva_tpu/backend/executor_jax.py JaxProgram._ks_mac,
//                      its mul_mont products and tree_sum adds)
//   E2 tensor_product  eva_tpu/backend/tables.py
//                      DeviceLevelOps.tensor_product (Karatsuba, 5
//                      Montgomery multiplies)
//   E3 divide_last     eva_tpu/backend/executor_jax.py divide_last_planes,
//                      looped over the k primes of a rescale (or the n_key
//                      key primes of a P-division) and over the 1-3
//                      polynomials of the call, with an optional addend
//   E4 modmul_burn     bench.py measure_vpu_modmul: a chain of 16 dependent
//                      Montgomery multiplies of each word by 3 and 5 in
//                      turn, which XLA fuses into one pass; the
//                      benchmark's modular-multiply rate probe (on no
//                      program's path)
//   galois_perm        no TPU kernel: the Galois automorphism of NTT-domain
//                      planes, out[.., j] = x[.., perm[j]], which the JAX
//                      package computes as a one-hot matmul on the MXU
//                      (executor_jax.py DevPerm) and the port first left to
//                      PyTorch's index_select (a gather kernel, ~5-6 us a
//                      call at one [4-13, 16384] plane); here the 1-4
//                      planes a rotation permutes (c0 and the key switch's
//                      two accumulators or outputs) in one launch
// Plain PyTorch versions: eva_tpu_torch/backend/modmath.py (E1, E2, E4)
// and backend/ks.py divide_last_plain (E3); torch.index_select on a CPU
// tensor (galois_perm, executor_torch.DevPerm). Every formula is the JAX
// package's, written literally (a compare and select where it has
// jnp.where), so the results are its uint32 results bit for bit, for
// every input it accepts (unreduced first operands up to 2^32 for the
// Montgomery and Shoup multiplies). Sums over digits are add_mod chains of
// canonical residues: exact and associative, so any order gives the JAX
// package's tree_sum residue.
//
// Layout: residues are uint32 words (int32 tensors carrying the uint32
// bit pattern). An E1 output plane is a contiguous [..., n_sub, n] tensor;
// row r of its flattened leading dims uses prime r % n_sub of the prime
// table. The planes of one multi launch share one table, of which each
// uses a prefix
// (the data primes are a prefix of the extended basis). Each operand is
// broadcast against its output by shape (size-1 dims) and may be strided:
// the wrapper passes, for the output's leading dims (coalesced, at most
// kMaxDims), their sizes and each operand's strides in words (0 where it
// broadcasts), and its stride along the last dim (1, or 0 for a per-row
// constant [n_sub, 1]).
//
// What bounds them on this card: bytes, and at batch 1 the launch. A
// modular multiply is ~9 32-bit integer operations per word against 12
// bytes moved (two reads, one write): 0.75 ops a byte, where the H100
// does ~5 (16.7e12 int32 op/s over 3.35 TB/s). At Sobel's level 0 one
// dyadic op over [11, 16384] moves 2.2 MB (0.65 us), less than a launch
// costs in a graph (~2.5 us). So the design:
//   - fewer launches: the multi form takes a rotation sum's four
//     components, a ciphertext's two or three; the MAC form a whole
//     structured inner product (own, foreign and key rows, both key
//     halves) with the sums in registers, where the JAX expression is ~20
//     separate ops plus concatenations; E3 divides by every prime of a
//     rescale and every polynomial of the call in one pass, carrying the
//     lift chain in registers;
//   - 16-byte loads and stores: each thread handles 4 words (uint4) where
//     every full-width operand is 16-byte aligned with strides that are
//     multiples of 4 words (the wrapper checks; else one word a thread);
//   - a grid that covers each row at once: one block of 256 threads per
//     1024 words of a row ([11, 16384]: 176 blocks, resident together on
//     the 132 SMs);
//   - descriptors passed by value as __grid_constant__ kernel parameters
//     (a captured CUDA graph replays the parameters it captured; nothing
//     is written to device memory at launch time);
//   - programmatic dependent launch: every kernel here is launched with
//     programmatic stream serialization and lets its own dependents
//     launch as it starts, so a chain of them overlaps each launch and
//     its index arithmetic with the previous kernel's tail; each waits
//     (griddepcontrol.wait) for the previous grid's completion before it
//     touches device memory (its inputs, and outputs that the stream's
//     allocator may have taken from tensors a previous kernel still
//     reads).
// A failed launch returns its error; nothing falls back.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDims = 8;    // leading dims of an output, coalesced
constexpr int kOperands = 3;   // a, b, c (E2: a-side, b-side)
constexpr int kMaxPlanes = 4;  // planes of one multi launch
constexpr int kMaxPolys = 3;   // polynomials of one E3 launch
constexpr int kMaxDiv = 8;     // primes one E3 launch divides by
constexpr int kThreads = 256;
constexpr int kVec = 4;        // words a thread handles (16 bytes)

// One output plane and its operands: the leading dims' sizes and each
// operand's strides along them (words; 0 where it broadcasts), its stride
// along the last dim, and the number of primes.
struct Plane {
  const uint32_t* src[kOperands];
  uint32_t* out;
  long long rows;
  int ndim, n_sub;
  int size[kMaxDims];
  long long stride[kOperands][kMaxDims];
  long long last[kOperands];
};

// The planes of one E1 launch, all n words wide; block row r belongs to
// the last plane k with first[k] <= r.
struct Planes {
  int count, n;
  long long first[kMaxPlanes];
  Plane p[kMaxPlanes];
};

// The structured MAC: digits own [.., n_cur, n], a [.., groups - 1, n_cur,
// n], b [.., groups, n_key, n] (leading dims strided along lead[0..2]),
// the keys' matching rows (k[0]: k0, k[1]: k1; no leading dims), and two
// contiguous outputs [.., n_cur + n_key, n].
struct Mac {
  const uint32_t* own;
  const uint32_t* a;
  const uint32_t* b;
  const uint32_t* k_own[2];
  const uint32_t* k_a[2];
  const uint32_t* k_b[2];
  uint32_t* out[2];
  int n, n_cur, n_key, groups, ndim;
  int size[kMaxDims];
  long long lead[3][kMaxDims];  // own, a, b
  long long row[3];             // own, a, b row strides
  long long dig[2];             // a, b digit strides
  long long krow[3], kdig[2];   // the keys' (k0 and k1 alike)
};

// E3: 1-3 contiguous [lead, n_rows, n] polynomials, optional addends of
// the same shape, the k primes to divide by (p[0] the last row's), and
// contiguous [lead, n_rows - k, n] outputs.
struct Div {
  const uint32_t* x[kMaxPolys];
  const uint32_t* add[kMaxPolys];
  uint32_t* out[kMaxPolys];
  uint32_t p[kMaxDiv];
  long long lead;
  int n_rows, n;
};

// galois_perm: 1-4 input planes, each [lead, n] with its leading dims
// (coalesced, at most kMaxDims; the rows included) strided in words and the
// last dim of stride 1, and contiguous outputs of the same shapes; block
// row r belongs to the last plane k with first[k] <= r.
struct PermPlane {
  const uint32_t* src;
  uint32_t* out;
  int ndim;
  int size[kMaxDims];
  long long stride[kMaxDims];
};

struct Perm {
  int count, n;
  long long first[kMaxPlanes];
  PermPlane p[kMaxPlanes];
};

// Programmatic dependent launch (see the header): the next kernel of the
// stream may start launching, and this one waits for the previous grid.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

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

// One divide-and-round step of E3: (v - centred(lift)) / p mod q, as
// mont_mul(v + p - lift, p^-1 R mod q) minus 1 when lift <= p / 2
// (v < q < 2^31 and p - lift <= p < 2^31: no wrap).
__device__ __forceinline__ uint32_t div_step(uint32_t v, uint32_t lift,
                                             uint32_t p, uint32_t w,
                                             uint32_t q, uint32_t nqinv) {
  const uint32_t r = mont_mul(v + (p - lift), w, q, nqinv);
  return sub_mod(r, lift > p / 2 ? 0u : 1u, q);
}

enum Op { kAdd = 0, kSub, kNeg, kMontMul, kMul, kShoup, kNumOps };

__host__ __device__ constexpr int arity(int op) {
  return op == kNeg ? 1 : (op == kMul || op == kShoup) ? 3 : 2;
}

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t q, uint32_t nqinv) {
  if constexpr (OP == kAdd) return add_mod(a, b, q);
  if constexpr (OP == kSub) return sub_mod(a, b, q);
  if constexpr (OP == kNeg) return neg_mod(a, q);
  if constexpr (OP == kMontMul) return mont_mul(a, b, q, nqinv);
  if constexpr (OP == kMul) return mont_mul(mont_mul(a, b, q, nqinv), c, q,
                                            nqinv);
  return shoup_mul(a, b, c, q);
}

// W words of one operand at column e: one 16-byte load (W == 4: stride 1,
// aligned), one word (W == 1), or a per-row constant (last == 0).
template <int W>
__device__ __forceinline__ void load(const uint32_t* src, long long off,
                                     long long last, int e,
                                     uint32_t (&v)[W]) {
  if (last == 0) {
    const uint32_t s = __ldg(src + off);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = s;
  } else if constexpr (W == kVec) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(src + off + e));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(src + off + e * last);
  }
}

template <int W>
__device__ __forceinline__ void load_row(const uint32_t* src, int e,
                                         uint32_t (&v)[W]) {
  load<W>(src, 0, 1, e, v);
}

template <int W>
__device__ __forceinline__ void store(uint32_t* dst, int e,
                                      const uint32_t (&v)[W]) {
  if constexpr (W == kVec) {
    *reinterpret_cast<uint4*>(dst + e) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    dst[e] = v[0];
  }
}

// The first column of this thread and the step between its columns.
template <int W>
__device__ __forceinline__ int first_col() {
  return (blockIdx.y * blockDim.x + threadIdx.x) * W;
}

template <int W>
__device__ __forceinline__ int col_step() {
  return gridDim.y * blockDim.x * W;
}

// The operands' offsets of output row `row` of a plane (flattened over its
// leading dims), walking the dims innermost first.
__device__ __forceinline__ void row_offsets(const Plane& pl, long long row,
                                            long long (&off)[kOperands]) {
#pragma unroll
  for (int k = 0; k < kOperands; ++k) off[k] = 0;
  for (int d = pl.ndim - 1; d >= 0; --d) {
    const long long i = row % pl.size[d];
    row /= pl.size[d];
#pragma unroll
    for (int k = 0; k < kOperands; ++k) off[k] += i * pl.stride[k][d];
  }
}

// E1 on one block row of the planes: out = OP(a, b, c) per word. b is
// unused by kNeg, c is r2 (R^2 mod q, per row) for kMul and wp for kShoup.
template <int OP, int W>
__device__ __forceinline__ void ew_row(const Planes& P,
                                       const uint32_t* __restrict__ qs,
                                       const uint32_t* __restrict__ nqinvs) {
  launch_dependents();
  long long row = blockIdx.x;
  int k = 0;
  while (k + 1 < P.count && row >= P.first[k + 1]) ++k;
  const Plane& pl = P.p[k];
  row -= P.first[k];
  long long off[kOperands];
  row_offsets(pl, row, off);
  const int p = (int)(row % pl.n_sub);
  wait_prior_grid();
  const uint32_t q = qs[p], nqinv = nqinvs[p];
  uint32_t* dst = pl.out + row * P.n;
  for (int e = first_col<W>(); e < P.n; e += col_step<W>()) {
    uint32_t a[W], b[W] = {}, c[W] = {}, v[W];
    load<W>(pl.src[0], off[0], pl.last[0], e, a);
    if constexpr (arity(OP) >= 2) load<W>(pl.src[1], off[1], pl.last[1], e, b);
    if constexpr (arity(OP) >= 3) load<W>(pl.src[2], off[2], pl.last[2], e, c);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = apply<OP>(a[w], b[w], c[w], q, nqinv);
    store<W>(dst, e, v);
  }
}

// E1, the single form: one plane.
template <int OP, int W>
__global__ void __launch_bounds__(kThreads)
    mod_ew_kernel(const __grid_constant__ Planes P,
                  const uint32_t* __restrict__ qs,
                  const uint32_t* __restrict__ nqinvs) {
  ew_row<OP, W>(P, qs, nqinvs);
}

// E1, the several-planes form: 2-4 planes (a kernel of its own name, so
// that a profile tells the forms apart).
template <int OP, int W>
__global__ void __launch_bounds__(kThreads)
    mod_ew_multi_kernel(const __grid_constant__ Planes P,
                        const uint32_t* __restrict__ qs,
                        const uint32_t* __restrict__ nqinvs) {
  ew_row<OP, W>(P, qs, nqinvs);
}

// E1, the MAC form: one block row is output row i of one batch element:
//   i <  n_cur: mont(own_i, k_own_i) + sum_j mont(a_ji, k_a_ji)  mod q_i
//   i >= n_cur: sum_j mont(b_j(i - n_cur), k_b_j(i - n_cur))      mod q_i
// for both key halves at once (each digit word read once), the sums in
// registers; q_i is row i of the extended basis (data, then key primes).
template <int W>
__global__ void __launch_bounds__(kThreads)
    mod_ew_mac_kernel(const __grid_constant__ Mac m,
                      const uint32_t* __restrict__ qs,
                      const uint32_t* __restrict__ nqinvs) {
  launch_dependents();
  const int n_ext = m.n_cur + m.n_key;
  long long lead = blockIdx.x / n_ext;
  const int i = (int)(blockIdx.x % n_ext);
  const long long out_off = (long long)blockIdx.x * m.n;
  long long off[3] = {0, 0, 0};
  for (int d = m.ndim - 1; d >= 0; --d) {
    const long long j = lead % m.size[d];
    lead /= m.size[d];
#pragma unroll
    for (int k = 0; k < 3; ++k) off[k] += j * m.lead[k][d];
  }
  wait_prior_grid();
  const uint32_t q = qs[i], nqinv = nqinvs[i];
  const bool data = i < m.n_cur;
  const int ii = data ? i : i - m.n_cur;
  for (int e = first_col<W>(); e < m.n; e += col_step<W>()) {
    uint32_t acc0[W] = {}, acc1[W] = {};
    for (int t = 0; t < m.groups; ++t) {
      const uint32_t *x, *k0, *k1;
      if (!data) {
        x = m.b + off[2] + t * m.dig[1] + ii * m.row[2];
        const long long kk = t * m.kdig[1] + ii * m.krow[2];
        k0 = m.k_b[0] + kk;
        k1 = m.k_b[1] + kk;
      } else if (t == 0) {
        x = m.own + off[0] + i * m.row[0];
        k0 = m.k_own[0] + i * m.krow[0];
        k1 = m.k_own[1] + i * m.krow[0];
      } else {
        x = m.a + off[1] + (t - 1) * m.dig[0] + i * m.row[1];
        const long long kk = (t - 1) * m.kdig[0] + i * m.krow[1];
        k0 = m.k_a[0] + kk;
        k1 = m.k_a[1] + kk;
      }
      uint32_t xv[W], v0[W], v1[W];
      load_row<W>(x, e, xv);
      load_row<W>(k0, e, v0);
      load_row<W>(k1, e, v1);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t p0 = mont_mul(xv[w], v0[w], q, nqinv);
        const uint32_t p1 = mont_mul(xv[w], v1[w], q, nqinv);
        acc0[w] = add_mod(acc0[w], p0, q);
        acc1[w] = add_mod(acc1[w], p1, q);
      }
    }
    store<W>(m.out[0] + out_off, e, acc0);
    store<W>(m.out[1] + out_off, e, acc1);
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
                          const uint32_t* __restrict__ r2s,
                          const __grid_constant__ Plane sh, int n) {
  launch_dependents();
  const long long row = blockIdx.x;
  long long off[kOperands];
  row_offsets(sh, row, off);
  const int p = (int)(row % sh.n_sub);
  wait_prior_grid();
  const uint32_t q = qs[p], nqinv = nqinvs[p], r2 = r2s[p];
  const size_t o = (size_t)row * n;
  for (int e = first_col<1>(); e < n; e += col_step<1>()) {
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

// E3: divide-and-round of [lead, n_rows, N] coefficient planes (plus the
// addend, added mod q first, when given) by their last K primes, the last
// first, into [lead, n_rows - K, N]. One block row per (polynomial, l,
// output row i); each thread carries its columns' lifts through the K
// divisions in registers: lift s is row n_rows - 1 - s after divisions
// 0 .. s - 1 (recomputed per block from rows that stay in L2), so only the
// output rows are written. pinv[s * (n_rows - 1) + r] = p_s^-1 R mod q_r.
template <int K, int W>
__global__ void __launch_bounds__(kThreads)
    divide_last_kernel(const __grid_constant__ Div d,
                       const uint32_t* __restrict__ qs,
                       const uint32_t* __restrict__ nqinvs,
                       const uint32_t* __restrict__ pinv) {
  launch_dependents();
  const int n_out = d.n_rows - K;
  long long row = blockIdx.x;
  const int i = (int)(row % n_out);
  row /= n_out;
  const long long l = row % d.lead;
  const int poly = (int)(row / d.lead);
  const long long base = l * d.n_rows * d.n;
  const uint32_t* src = d.x[poly] + base;
  const uint32_t* add = d.add[poly];
  uint32_t* dst = d.out[poly] + (l * n_out + i) * d.n;
  const int stride = d.n_rows - 1;
  wait_prior_grid();

  // Row r of the input (plus the addend, mod q_r: the tables hold the
  // first n_rows - 1 primes, and the last row's is p[0]), W words at
  // column e.
  auto input = [&](int r, int e, uint32_t (&v)[W]) {
    load_row<W>(src + (long long)r * d.n, e, v);
    if (add != nullptr) {
      const uint32_t q = r < stride ? qs[r] : d.p[0];
      uint32_t s[W];
      load_row<W>(add + base + (long long)r * d.n, e, s);
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = add_mod(v[w], s[w], q);
    }
  };

  for (int e = first_col<W>(); e < d.n; e += col_step<W>()) {
    uint32_t lift[K][W];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int r = d.n_rows - 1 - s;
      input(r, e, lift[s]);
#pragma unroll
      for (int t = 0; t < s; ++t) {
        const uint32_t w_t = pinv[t * stride + r];
#pragma unroll
        for (int w = 0; w < W; ++w)
          lift[s][w] = div_step(lift[s][w], lift[t][w], d.p[t], w_t, qs[r],
                                nqinvs[r]);
      }
    }
    uint32_t v[W];
    input(i, e, v);
    const uint32_t q = qs[i], nqinv = nqinvs[i];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const uint32_t w_s = pinv[s * stride + i];
#pragma unroll
      for (int w = 0; w < W; ++w)
        v[w] = div_step(v[w], lift[s][w], d.p[s], w_s, q, nqinv);
    }
    store<W>(dst, e, v);
  }
}

// E4: out = x times 3, 5, 3, ... (kBurnK Montgomery multiplies, each on
// the previous product) per word of a contiguous [rows, 2^logn] plane, row
// r on prime r % n_sub. A plain grid-stride loop: each word's chain stays
// in registers, so the multiplies, not the 8 bytes a word moves, bound it
// (16 32-bit Montgomery multiplies of 6 integer instructions each against
// 8 bytes).
constexpr int kBurnK = 16;
__global__ void __launch_bounds__(kThreads)
    modmul_burn_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ qs,
                       const uint32_t* __restrict__ nqinvs, int logn,
                       int n_sub, unsigned total) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned p = (i >> logn) % (unsigned)n_sub;
    const uint32_t q = __ldg(qs + p), nqinv = __ldg(nqinvs + p);
    uint32_t v = __ldg(x + i);
#pragma unroll
    for (int j = 0; j < kBurnK; ++j)
      v = mont_mul(v, (j & 1) ? 5u : 3u, q, nqinv);
    out[i] = v;
  }
}

// galois_perm: block row `row` of the planes -> its input row and its
// output row.
__device__ __forceinline__ const uint32_t* perm_rows(const Perm& P,
                                                     long long row,
                                                     uint32_t** dst) {
  int k = 0;
  while (k + 1 < P.count && row >= P.first[k + 1]) ++k;
  const PermPlane& pl = P.p[k];
  row -= P.first[k];
  *dst = pl.out + row * P.n;
  long long off = 0;
  for (int d = pl.ndim - 1; d >= 0; --d) {
    off += (row % pl.size[d]) * pl.stride[d];
    row /= pl.size[d];
  }
  return pl.src + off;
}

// galois_perm: out[j] = src[perm[j]] over one output row, kVec words a
// thread: the table's words and the stores coalesced (16 bytes a thread),
// the reads gathered through L1/L2 (a row is 64 KB at N = 16384). Bytes
// bound it, and at a rotation's three planes the launch: 1.4-2.0 us
// against 0.9-1.5 us of bytes. Staging each input row in shared memory
// first and gathering from there measured 2-2.5x slower at those shapes
// (a block a row leaves most SMs idle; a row split over blocks is copied
// once per block). The table is written once, at set-up, before any
// launch that reads it, so its words are loaded before the wait for the
// previous grid.
__global__ void __launch_bounds__(kThreads)
    galois_perm_kernel(const __grid_constant__ Perm P,
                       const int* __restrict__ perm) {
  launch_dependents();
  uint32_t* dst;
  const uint32_t* src = perm_rows(P, blockIdx.x, &dst);
  const int e0 = first_col<kVec>();
  int4 idx = e0 < P.n ? __ldg(reinterpret_cast<const int4*>(perm + e0))
                      : make_int4(0, 0, 0, 0);
  wait_prior_grid();
  for (int e = e0; e < P.n; e += col_step<kVec>()) {
    if (e != e0) idx = __ldg(reinterpret_cast<const int4*>(perm + e));
    const uint32_t v[kVec] = {__ldg(src + idx.x), __ldg(src + idx.y),
                              __ldg(src + idx.z), __ldg(src + idx.w)};
    store<kVec>(dst, e, v);
  }
}

// The grid of `rows` block rows of n words, W words a thread: one block
// per row and kThreads * W columns.
template <int W>
dim3 grid(long long rows, int n) {
  const int chunks = (n + kThreads * W - 1) / (kThreads * W);
  return dim3((unsigned)rows, (unsigned)chunks);
}

// A Plane from its host description: dims[0 .. ndim) sizes, then for each
// operand slot k its ndim strides at dims[ndim (1 + k) ..], then the
// slots' last-dim strides. Returns false when it does not fit.
bool make_plane(int ndim, int n_sub, const long long* dims, Plane* pl) {
  if (ndim < 0 || ndim > kMaxDims || n_sub <= 0) return false;
  *pl = Plane{};
  pl->ndim = ndim;
  pl->n_sub = n_sub;
  pl->rows = 1;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0) return false;
    pl->size[d] = (int)dims[d];
    pl->rows *= dims[d];
    for (int k = 0; k < kOperands; ++k)
      pl->stride[k][d] = dims[ndim * (1 + k) + d];
  }
  for (int k = 0; k < kOperands; ++k)
    pl->last[k] = dims[ndim * (1 + kOperands) + k];
  return pl->rows <= 0x7fffffffLL && pl->rows % n_sub == 0;
}

// Launches `kernel` on `grid` x kThreads with programmatic stream
// serialization (see the header); returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, cudaStream_t stream,
                   const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int OP, int W>
cudaError_t launch_ew_w(const Planes& P, long long rows, const uint32_t* q,
                      const uint32_t* nqinv, cudaStream_t stream) {
  return P.count == 1
             ? launch(mod_ew_kernel<OP, W>, grid<W>(rows, P.n), stream, P, q,
                      nqinv)
             : launch(mod_ew_multi_kernel<OP, W>, grid<W>(rows, P.n), stream,
                      P, q, nqinv);
}

template <int OP>
cudaError_t launch_ew(bool vec, const Planes& P, long long rows,
                      const uint32_t* q, const uint32_t* nqinv,
                      cudaStream_t stream) {
  return vec ? launch_ew_w<OP, kVec>(P, rows, q, nqinv, stream)
             : launch_ew_w<OP, 1>(P, rows, q, nqinv, stream);
}

template <int K, int W>
cudaError_t launch_div_w(const Div& d, long long rows, const uint32_t* q,
                       const uint32_t* nqinv, const uint32_t* pinv,
                       cudaStream_t stream) {
  return launch(divide_last_kernel<K, W>, grid<W>(rows, d.n), stream, d, q,
                nqinv, pinv);
}

template <int K>
cudaError_t launch_div(bool vec, const Div& d, long long rows,
                       const uint32_t* q, const uint32_t* nqinv,
                       const uint32_t* pinv, cudaStream_t stream) {
  return vec ? launch_div_w<K, kVec>(d, rows, q, nqinv, pinv, stream)
             : launch_div_w<K, 1>(d, rows, q, nqinv, pinv, stream);
}

}  // namespace

extern "C" {

// E1: out[k] = op(src[3k], src[3k + 1], src[3k + 2]) over plane k < count
// (1: the single form; 2-4: the multi form), each described by meta[2k],
// meta[2k + 1] = (ndim, n_sub) and its block of 4 ndim + 3 values in dims
// (see make_plane), one after the other; all planes n words wide; row r
// of plane k uses prime r % n_sub of the tables q, nqinv.
// src entries an op does not read may be null. vec: every full-width
// operand is 16-byte aligned with strides that are multiples of 4 words,
// and n % 4 == 0 (4 words a thread). Returns the launch's cudaError_t.
int eva_mod_ew(int op, int count, const void* const* src, void* const* out,
               const void* q, const void* nqinv, int n, const int* meta,
               const long long* dims, int vec, void* stream) {
  if (op < 0 || op >= kNumOps || count < 1 || count > kMaxPlanes || n <= 0 ||
      (vec && n % kVec))
    return (int)cudaErrorInvalidValue;
  Planes P{};
  P.count = count;
  P.n = n;
  long long rows = 0;
  for (int k = 0; k < count; ++k) {
    Plane& pl = P.p[k];
    const int ndim = meta[2 * k];
    if (!make_plane(ndim, meta[2 * k + 1], dims, &pl))
      return (int)cudaErrorInvalidValue;
    dims += 4 * ndim + kOperands;
    for (int j = 0; j < kOperands; ++j)
      pl.src[j] = (const uint32_t*)src[kOperands * k + j];
    pl.out = (uint32_t*)out[k];
    P.first[k] = rows;
    rows += pl.rows;
  }
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* qs = (const uint32_t*)q;
  const auto* nq = (const uint32_t*)nqinv;
  const auto s = (cudaStream_t)stream;
  switch (op) {
    case kAdd: return (int)launch_ew<kAdd>(vec, P, rows, qs, nq, s);
    case kSub: return (int)launch_ew<kSub>(vec, P, rows, qs, nq, s);
    case kNeg: return (int)launch_ew<kNeg>(vec, P, rows, qs, nq, s);
    case kMontMul: return (int)launch_ew<kMontMul>(vec, P, rows, qs, nq, s);
    case kMul: return (int)launch_ew<kMul>(vec, P, rows, qs, nq, s);
    default: return (int)launch_ew<kShoup>(vec, P, rows, qs, nq, s);
  }
}

// E1, the MAC form: out0, out1 [lead, n_cur + n_key, n] from the digits
// own, a (null when groups == 1), b and keys[0 .. 6) = k0_own, k1_own,
// k0_a, k1_a, k0_b, k1_b. dims: the ndim leading dims' sizes, then the
// strides along them of own, a and b (ndim each), then the row strides of
// own, a, b, the digit strides of a, b, the keys' row strides (own, a, b)
// and digit strides (a, b). q, nqinv: the extended basis's tables.
int eva_mod_ew_mac(const void* own, const void* a, const void* b,
                   const void* const* keys, void* out0, void* out1,
                   const void* q, const void* nqinv, int n, int n_cur,
                   int n_key, int groups, int ndim, const long long* dims,
                   int vec, void* stream) {
  if (n <= 0 || n_cur <= 0 || n_key <= 0 || groups < 1 || ndim < 0 ||
      ndim > kMaxDims || (groups > 1 && a == nullptr) || (vec && n % kVec))
    return (int)cudaErrorInvalidValue;
  Mac m{};
  m.own = (const uint32_t*)own;
  m.a = (const uint32_t*)a;
  m.b = (const uint32_t*)b;
  for (int h = 0; h < 2; ++h) {
    m.k_own[h] = (const uint32_t*)keys[h];
    m.k_a[h] = (const uint32_t*)keys[2 + h];
    m.k_b[h] = (const uint32_t*)keys[4 + h];
  }
  m.out[0] = (uint32_t*)out0;
  m.out[1] = (uint32_t*)out1;
  m.n = n;
  m.n_cur = n_cur;
  m.n_key = n_key;
  m.groups = groups;
  m.ndim = ndim;
  long long rows = n_cur + n_key;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0) return (int)cudaErrorInvalidValue;
    m.size[d] = (int)dims[d];
    rows *= dims[d];
    for (int k = 0; k < 3; ++k) m.lead[k][d] = dims[ndim * (1 + k) + d];
  }
  const long long* s = dims + 4 * ndim;
  for (int k = 0; k < 3; ++k) m.row[k] = s[k];
  m.dig[0] = s[3], m.dig[1] = s[4];
  for (int k = 0; k < 3; ++k) m.krow[k] = s[5 + k];
  m.kdig[0] = s[8], m.kdig[1] = s[9];
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const auto* qs = (const uint32_t*)q;
  const auto* nq = (const uint32_t*)nqinv;
  return (int)(vec ? launch(mod_ew_mac_kernel<kVec>, grid<kVec>(rows, n), st,
                            m, qs, nq)
                   : launch(mod_ew_mac_kernel<1>, grid<1>(rows, n), st, m, qs,
                            nq));
}

// E2: (d0, d1, d2) = tensor product of (a0, a1) and (b0, b1) over the
// broadcast shape dims (operand slot 0: the a-side, 1: the b-side).
int eva_tensor_product(const void* a0, const void* a1, const void* b0,
                       const void* b1, void* d0, void* d1, void* d2,
                       const void* q, const void* nqinv, const void* r2,
                       int ndim, int n, int n_sub, const long long* dims,
                       void* stream) {
  Plane sh;
  if (n <= 0 || !make_plane(ndim, n_sub, dims, &sh))
    return (int)cudaErrorInvalidValue;
  return (int)launch(
      tensor_product_kernel, grid<1>(sh.rows, n), (cudaStream_t)stream,
      (const uint32_t*)a0, (const uint32_t*)a1, (const uint32_t*)b0,
      (const uint32_t*)b1, (uint32_t*)d0, (uint32_t*)d1, (uint32_t*)d2,
      (const uint32_t*)q, (const uint32_t*)nqinv, (const uint32_t*)r2, sh, n);
}

// E3: out[j] [lead, n_rows - k, n] = (x[j] + add[j]) [lead, n_rows, n]
// divided by its last k primes p[0 .. k) (p[0] the last row's), for
// j < polys; add[j] may be null. q, nqinv: the tables of the first
// n_rows - 1 primes; pinv: [k, n_rows - 1] (see divide_last_kernel). vec as in
// eva_mod_ew (x, add and out contiguous).
int eva_divide_last(int polys, const void* const* x, const void* const* add,
                    void* const* out, const void* q, const void* nqinv,
                    const void* pinv, const unsigned* p, int k,
                    long long lead, int n_rows, int n, int vec,
                    void* stream) {
  const long long rows = (long long)polys * lead * (n_rows - k);
  if (polys < 1 || polys > kMaxPolys || k < 1 || k > kMaxDiv || lead <= 0 ||
      n_rows <= k || n <= 0 || rows > 0x7fffffffLL || (vec && n % kVec))
    return (int)cudaErrorInvalidValue;
  Div d{};
  for (int j = 0; j < polys; ++j) {
    d.x[j] = (const uint32_t*)x[j];
    d.add[j] = (const uint32_t*)add[j];
    d.out[j] = (uint32_t*)out[j];
  }
  for (int s = 0; s < k; ++s) d.p[s] = p[s];
  d.lead = lead;
  d.n_rows = n_rows;
  d.n = n;
  const auto* qs = (const uint32_t*)q;
  const auto* nq = (const uint32_t*)nqinv;
  const auto* pv = (const uint32_t*)pinv;
  const auto s = (cudaStream_t)stream;
  switch (k) {
    case 1: return (int)launch_div<1>(vec, d, rows, qs, nq, pv, s);
    case 2: return (int)launch_div<2>(vec, d, rows, qs, nq, pv, s);
    case 3: return (int)launch_div<3>(vec, d, rows, qs, nq, pv, s);
    case 4: return (int)launch_div<4>(vec, d, rows, qs, nq, pv, s);
    case 5: return (int)launch_div<5>(vec, d, rows, qs, nq, pv, s);
    case 6: return (int)launch_div<6>(vec, d, rows, qs, nq, pv, s);
    case 7: return (int)launch_div<7>(vec, d, rows, qs, nq, pv, s);
    default: return (int)launch_div<8>(vec, d, rows, qs, nq, pv, s);
  }
}

// E4: out [rows, 2^logn] = x after kBurnK Montgomery multiplies by 3, 5
// in turn, row r on prime r % n_sub of the tables q, nqinv; x and out
// contiguous, total = rows 2^logn words (< 2^31). A grid of at most eight
// blocks per SM, striding over the words.
int eva_modmul_burn(const void* x, void* out, const void* q, const void* nqinv,
                    int logn, int n_sub, long long total, void* stream) {
  if (logn < 0 || logn > 30 || n_sub <= 0 || total <= 0 ||
      total > 0x7fffffffLL || total % (1LL << logn) != 0)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 8LL * sms ? want : 8LL * sms);
  modmul_burn_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)q,
      (const uint32_t*)nqinv, logn, n_sub, (unsigned)total);
  return (int)cudaGetLastError();
}

// galois_perm: out[k][.., j] = src[k][.., perm[j]] for the count <= 4
// planes, each described by meta[k] = ndim and its 2 ndim values in dims
// (its leading dims' sizes, then the input's strides along them, in
// words), one after the other; n % 4 == 0, perm a permutation of 0 .. n-1
// (int32). Returns the launch's cudaError_t.
int eva_galois_perm(int count, const void* const* src, void* const* out,
                    const void* perm, int n, const int* meta,
                    const long long* dims, void* stream) {
  if (count < 1 || count > kMaxPlanes || n <= 0 || n % kVec)
    return (int)cudaErrorInvalidValue;
  Perm P{};
  P.count = count;
  P.n = n;
  long long rows = 0;
  for (int k = 0; k < count; ++k) {
    PermPlane& pl = P.p[k];
    const int ndim = meta[k];
    if (ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
    pl.src = (const uint32_t*)src[k];
    pl.out = (uint32_t*)out[k];
    pl.ndim = ndim;
    long long r = 1;
    for (int d = 0; d < ndim; ++d) {
      if (dims[d] <= 0) return (int)cudaErrorInvalidValue;
      pl.size[d] = (int)dims[d];
      pl.stride[d] = dims[ndim + d];
      r *= dims[d];
    }
    dims += 2 * ndim;
    P.first[k] = rows;
    rows += r;
  }
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)launch(galois_perm_kernel, grid<kVec>(rows, n),
                     (cudaStream_t)stream, P, (const int*)perm);
}

// Resource use, for reports: out[2j], out[2j + 1] = registers and local
// (spill) bytes per thread of kernel j, in this order, each at 4 words a
// thread: the single form of E1 op k (k < 6), its multi form (k < 6), the
// MAC form, E2 (one word a thread), E3 at k = 1 .. 8, E4, galois_perm.
// Returns the count
// of kernels, or minus a cudaError_t.
int eva_modmath_info(int* out) {
  const void* fns[] = {
      (const void*)mod_ew_kernel<kAdd, kVec>,
      (const void*)mod_ew_kernel<kSub, kVec>,
      (const void*)mod_ew_kernel<kNeg, kVec>,
      (const void*)mod_ew_kernel<kMontMul, kVec>,
      (const void*)mod_ew_kernel<kMul, kVec>,
      (const void*)mod_ew_kernel<kShoup, kVec>,
      (const void*)mod_ew_multi_kernel<kAdd, kVec>,
      (const void*)mod_ew_multi_kernel<kSub, kVec>,
      (const void*)mod_ew_multi_kernel<kNeg, kVec>,
      (const void*)mod_ew_multi_kernel<kMontMul, kVec>,
      (const void*)mod_ew_multi_kernel<kMul, kVec>,
      (const void*)mod_ew_multi_kernel<kShoup, kVec>,
      (const void*)mod_ew_mac_kernel<kVec>,
      (const void*)tensor_product_kernel,
      (const void*)divide_last_kernel<1, kVec>,
      (const void*)divide_last_kernel<2, kVec>,
      (const void*)divide_last_kernel<3, kVec>,
      (const void*)divide_last_kernel<4, kVec>,
      (const void*)divide_last_kernel<5, kVec>,
      (const void*)divide_last_kernel<6, kVec>,
      (const void*)divide_last_kernel<7, kVec>,
      (const void*)divide_last_kernel<8, kVec>,
      (const void*)modmul_burn_kernel,
      (const void*)galois_perm_kernel};
  const int count = (int)(sizeof(fns) / sizeof(fns[0]));
  for (int j = 0; j < count; ++j) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fns[j]);
    if (err != cudaSuccess) return -(int)err;
    out[2 * j] = attr.numRegs;
    out[2 * j + 1] = (int)attr.localSizeBytes;
  }
  return count;
}

}  // extern "C"
