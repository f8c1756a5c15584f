// The Top-K transport kernels of FLASC for Hopper, sm_90a: one source, seven
// C entry points.  Every input is a (rows, n) f32 matrix, row-major and
// contiguous; each row is one message (the download vector, or one client's
// upload delta), with its own threshold, bound and scale.
//
// TPU kernels replaced (src/repro/kernels/...):
//   topk_mask.py::threshold_count_pallas      -> threshold_count_f32
//       (mask_count_kernel<false>: count of |x| >= t per row)
//   topk_mask.py::topk_mask_pallas            -> topk_mask_f32
//       (mask_count_kernel<true>: x * (|x| >= t) and the kept count)
//   fused_transport.py::absmax_pallas         -> absmax_f32
//   fused_transport.py::bin_counts_pallas     -> bin_counts_f32
//       (bin_partial_kernel<L> and bin_sum_kernel: see "bin_counts" below)
//   fused_transport.py::fused_mask_quantize_pallas -> mask_quantize_f32
//   fused_transport.py::fused_mask_quantize_pack_pallas
//                                             -> mask_quantize_pack_f32
//   fused_transport.py::pack_values_batched_pallas -> pack_batch_f32
//       (the two pack kernels: see "pack" below)
//
// What bounds them on an H100: each is one streaming pass over the rows
// with a handful of operations per element, far below the f32 rate, so
// they are bound by bytes at 3.35 TB/s.  At the Yi-9B LoRA vector
// (n = 9,830,400 f32, 39.3 MB a row): absmax, threshold_count and
// bin_counts read a row once (11.7 us); topk_mask reads and writes a row
// (23.5 us); mask_quantize reads x and the uniform draw u and writes the
// result (35 us a row, 141 us for 4 clients).  bin_counts is the exception
// in how close it can come: replaying the 12-step bisection per element
// costs about 73 instructions an element, 7.2e8 lane-instructions a row,
// about 21 us of issue at one instruction per lane per clock: issue-bound,
// not bytes-bound.  Its design below searches a table instead.
//
// Design of the streaming passes:
//   - grid (blocks over the row, rows); each thread strides over its row,
//     16-byte float4 loads and stores where the row is 16-byte aligned and
//     n % 4 == 0, scalar loads otherwise (and for the ragged tail).  Enough
//     blocks run to keep every SM streaming.
//   - cross-block results combine with order-free atomics, so every result
//     is exact and bitwise reproducible: integer adds for counts, an
//     unsigned max on the bits of |x| for absmax (non-negative floats order
//     as their bit patterns).  The wrapper zeroes the outputs first.
//   - the ragged tail is masked, never padded: unlike the Pallas version no
//     pad zeros land in bin 0.  No threshold ever reads bin 0.
//   - arithmetic is op for op the reference's, with IEEE rounding spelled
//     out (__fadd_rn, __fmul_rn, __fdiv_rn) so that no contraction or fast
//     path changes a bit: mid = 0.5f * (lo + hi); y = x / scale; floor(y + u)
//     or rint(y) (half to even); clip to [-qmax - 1, qmax], NaN kept;
//     y * scale.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 12;
// blocks in flight over all rows for the streaming passes: 16 per SM
constexpr long long kStreamBlocks = 132 * 16;

__device__ __forceinline__ int block_sum(int v) {
  __shared__ int part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += part[w];
  }
  return v;  // the block's total, in thread 0
}

__device__ __forceinline__ unsigned block_max(unsigned v) {
  __shared__ unsigned part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = max(v, part[w]);
  }
  return v;
}

__device__ __forceinline__ long long thread_start() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long thread_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// ---------------------------------------------------------------------------
// mask_count<WRITE>: threshold_count (WRITE = false) and topk_mask (true)
// ---------------------------------------------------------------------------

template <bool WRITE>
__global__ void __launch_bounds__(kThreads)
mask_count_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                  float* __restrict__ out, int* __restrict__ cnt, long long n,
                  int vec) {
  const int b = blockIdx.y;
  const float* row = x + b * n;
  float* orow = WRITE ? out + b * n : nullptr;
  const float t = thr[b];
  const long long start = thread_start(), stride = thread_stride();
  int c = 0;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (long long v = start; v < n4; v += stride) {
      const float4 q = r4[v];
      const bool k0 = fabsf(q.x) >= t, k1 = fabsf(q.y) >= t;
      const bool k2 = fabsf(q.z) >= t, k3 = fabsf(q.w) >= t;
      c += static_cast<int>(k0) + k1 + k2 + k3;
      if (WRITE) {
        reinterpret_cast<float4*>(orow)[v] = make_float4(
            k0 ? q.x : 0.0f, k1 ? q.y : 0.0f, k2 ? q.z : 0.0f,
            k3 ? q.w : 0.0f);
      }
    }
    tail = n4 << 2;
  }
  for (long long i = tail + start; i < n; i += stride) {
    const float v = row[i];
    const bool keep = fabsf(v) >= t;
    c += keep;
    if (WRITE) orow[i] = keep ? v : 0.0f;
  }
  c = block_sum(c);
  if (threadIdx.x == 0 && c) atomicAdd(cnt + b, c);
}

// ---------------------------------------------------------------------------
// absmax: max |x| per row, as the bits of a non-negative float
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, unsigned* __restrict__ out,
              long long n, int vec) {
  const int b = blockIdx.y;
  const float* row = x + b * n;
  const long long start = thread_start(), stride = thread_stride();
  unsigned m = 0;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (long long v = start; v < n4; v += stride) {
      const float4 q = r4[v];
      m = max(m, max(max(__float_as_uint(fabsf(q.x)), __float_as_uint(fabsf(q.y))),
                     max(__float_as_uint(fabsf(q.z)), __float_as_uint(fabsf(q.w)))));
    }
    tail = n4 << 2;
  }
  for (long long i = tail + start; i < n; i += stride) {
    m = max(m, __float_as_uint(fabsf(row[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0 && m) atomicMax(out + b, m);
}

// ---------------------------------------------------------------------------
// bin_counts<L>: histogram of the L-step bisection leaf of every |x|
// ---------------------------------------------------------------------------
//
// The leaf of a = |x| is where the replay of mid = rn(0.5 * rn(lo + hi)),
// up = a >= mid, from (0, hi0[row]) ends after L steps.  Every node's mid
// lies in [lo, hi] (an overflowing lo + hi gives +inf, and the order still
// holds), so the 2^L - 1 midpoints of the tree read in order, edge[1 ..
// 2^L - 1], are sorted, and the leaf is the number of edges <= a.  So:
//   1. each block builds the edge table in shared memory: thread by thread,
//      node j is the mid its own path from the root replays (the replay's
//      ops and operands), one barrier for the whole table;
//   2. each element guesses g = floor(a * (2^L / hi0)).  The edges lie
//      within (L - 1) * 2^-24 * hi0 of the uniform grid j * hi0 / 2^L and
//      the guess within 2 * 2^-24 * a of a * 2^L / hi0, so where hi0 is a
//      normal number in [2^-100, 2^126] (no mid underflows or overflows)
//      and the guess lies more than (L + 4) * 2^(L-24) of a bin from a grid
//      line, g is the leaf: no table read (all but about 0.8% of normal
//      draws at L = 12);
//   3. otherwise the element checks edge[g] <= a < edge[g + 1] in the
//      table, moves one bin toward the side that failed and checks again;
//   4. where that fails too (hi0 denormal, near FLT_MAX, 0, inf, NaN or
//      negative; a NaN element), it walks the tree over the table: L shared
//      loads and compares that are the replay itself, mids read instead of
//      recomputed.  So every path returns the replay's leaf bit for bit.
// Each block counts into one 2^L-bin int histogram in shared memory (16
// KiB at L = 12) and writes it whole to its slot of the scratch; a second
// kernel, launched as a programmatic dependent so that its launch hides
// behind the first one's tail, sums a row's partials per bin.  No global
// atomics, no zeroed output, a fixed summation of ints: exact and
// deterministic.  Each block streams its part of the row with 16-byte
// loads, the first two issued before the table is built; two blocks fit
// an SM (32 registers a thread), so at B = 4 one block's table and flush
// overlap another's loads.
// Bound: the row read once (11.7 us at the Yi-9B vector).  On an H100 the
// read-once absmax kernel takes about 15.9 us of that row (chip_smoke.py
// phase 5); the table, the flush and the sum kernel come on top.

constexpr int kBinThreads = 1024;
constexpr int kBinParts = 132;             // partial histograms a row: one per SM
constexpr long long kBinMinBlock = 8192;   // elements a block at least
constexpr int kSumWarps = 16;

// the replay over the edge table: L loads and compares
template <int L>
__device__ __forceinline__ int tree_leaf(float a, const float* edge) {
  int pos = 1 << (L - 1), leaf = 0;
#pragma unroll
  for (int d = 0; d < L; ++d) {
    const bool up = a >= edge[pos];
    leaf = 2 * leaf + static_cast<int>(up);
    const int half = (1 << L) >> (d + 2);   // 0 after the last level
    pos += up ? half : -half;
  }
  return leaf;
}

// steps 2-4 for one element; `guess_ok`: hi0 in [2^-100, 2^126], where
// step 2 holds; `sorted`: hi0 is not negative, so the table is sorted
template <int L>
__device__ __forceinline__ int bin_leaf(float v, const float* edge,
                                        float scale, bool guess_ok,
                                        bool sorted) {
  constexpr int kTop = (1 << L) - 1;
  constexpr float kEps = (L + 4) * (1.0f / (1 << (24 - L)));
  const float a = fabsf(v);
  const float q = __fmul_rn(a, scale);
  const float m = floorf(q);
  const float f = __fsub_rn(q, m);         // NaN where q is NaN or inf
  int g = static_cast<int>(fminf(fmaxf(m, 0.0f), static_cast<float>(kTop)));
  if (guess_ok && (m == 0.0f || f >= kEps) &&
      (m >= static_cast<float>(kTop) || f <= 1.0f - kEps)) {
    return g;
  }
  if (sorted) {
    bool lo_ok = g == 0 || edge[g] <= a;
    bool hi_ok = g == kTop || a < edge[g + 1];
    if (lo_ok != hi_ok) {                  // one bin toward the failed side
      g += lo_ok ? 1 : -1;
      lo_ok = g == 0 || edge[g] <= a;
      hi_ok = g == kTop || a < edge[g + 1];
    }
    if (lo_ok && hi_ok) return g;
  }
  return tree_leaf<L>(a, edge);
}

template <int L>
__global__ void __launch_bounds__(kBinThreads, 2)
bin_partial_kernel(const float* __restrict__ x, const float* __restrict__ hi0,
                   int* __restrict__ part, long long n, int vec) {
  __shared__ float edge[1 << L];           // edge[1 .. 2^L - 1]
  __shared__ int h[1 << L];
  hopper::pdl_launch_dependents();
  const int b = blockIdx.y;
  const float top = hi0[b];
  const float* row = x + b * n;
  const long long start = static_cast<long long>(blockIdx.x) * kBinThreads +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kBinThreads;
  const long long n4 = vec ? n >> 2 : 0;
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 next[2];                          // in flight while the table builds
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long i = start + u * stride;
    next[u] = i < n4 ? r4[i] : zero;
  }
  for (int i = threadIdx.x; i < (1 << L); i += kBinThreads) h[i] = 0;
  for (int j = threadIdx.x + 1; j < (1 << L); j += kBinThreads) {
    const int depth = L - __ffs(j);        // node j = (2p + 1) << (L-1-depth)
    float lo = 0.0f, hi = top;
    for (int d = 0; d < depth; ++d) {      // the path: bits L-1, L-2, ... of j
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      const bool up = (j >> (L - 1 - d)) & 1;
      lo = up ? mid : lo;
      hi = up ? hi : mid;
    }
    edge[j] = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  }
  __syncthreads();
  const float scale = __fdiv_rn(static_cast<float>(1 << L), top);
  const bool guess_ok = top >= 0x1p-100f && top <= 0x1p126f;
  const bool sorted = !(top < 0.0f);
  for (long long v = start; v < n4; v += 2 * stride) {
    float4 cur[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cur[u] = next[u];
      const long long i = v + (2 + u) * stride;
      next[u] = i < n4 ? r4[i] : zero;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (v + u * stride < n4) {
        const float e[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          atomicAdd(&h[bin_leaf<L>(e[k], edge, scale, guess_ok, sorted)], 1);
        }
      }
    }
  }
  for (long long i = (n4 << 2) + start; i < n; i += stride) {
    atomicAdd(&h[bin_leaf<L>(row[i], edge, scale, guess_ok, sorted)], 1);
  }
  __syncthreads();
  int* out = part + ((static_cast<long long>(b) * gridDim.x + blockIdx.x) << L);
  for (int i = threadIdx.x; i < (1 << L); i += kBinThreads) out[i] = h[i];
}

// hist[row][bin] = the sum of the row's `parts` partials at bin: 32 bins a
// block, kSumWarps warps striding over the partials, then summed in order
__global__ void __launch_bounds__(32 * kSumWarps)
bin_sum_kernel(const int* __restrict__ part, int* __restrict__ hist,
               int parts, int bins) {
  __shared__ int acc[kSumWarps][32];
  hopper::pdl_wait();
  const int b = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bin = blockIdx.x * 32 + lane;
  int s = 0;
  if (bin < bins) {
    const int* p = part + static_cast<long long>(b) * parts * bins + bin;
    for (int g = w; g < parts; g += kSumWarps) {
      s += p[static_cast<long long>(g) * bins];
    }
  }
  acc[w][lane] = s;
  __syncthreads();
  if (w == 0 && bin < bins) {
#pragma unroll
    for (int k = 1; k < kSumWarps; ++k) s += acc[k][lane];
    hist[static_cast<long long>(b) * bins + bin] = s;
  }
}

// ---------------------------------------------------------------------------
// mask_quantize<QUANT, STOCHASTIC>: mask at t, b-bit quantize the survivors,
// count them
// ---------------------------------------------------------------------------

template <bool QUANT, bool STOCHASTIC>
__device__ __forceinline__ float masked_level(float v, float uu, float t,
                                              float scale, float qmax) {
  if (!(fabsf(v) >= t)) return 0.0f;
  if (!QUANT) return v;
  float y = __fdiv_rn(v, scale);
  y = STOCHASTIC ? floorf(__fadd_rn(y, uu)) : rintf(y);
  // clip; a NaN y stays NaN, as under torch.clamp and jnp.clip (fminf and
  // fmaxf alone would return a bound).  A kept y is NaN where x is +-inf and
  // the row's scale inf (a row holding an inf): inf / inf.
  y = isnan(y) ? y : fminf(fmaxf(y, -qmax - 1.0f), qmax);
  return __fmul_rn(y, scale);
}

template <bool QUANT, bool STOCHASTIC>
__global__ void __launch_bounds__(kThreads)
mask_quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ thr,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int* __restrict__ cnt, long long n, float qmax, int vec) {
  const int b = blockIdx.y;
  const float* row = x + b * n;
  const float* urow = STOCHASTIC ? u + b * n : nullptr;
  float* orow = out + b * n;
  const float t = thr[b];
  const float s = QUANT ? scale[b] : 1.0f;
  const long long start = thread_start(), stride = thread_stride();
  int c = 0;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (long long v = start; v < n4; v += stride) {
      const float4 q = r4[v];
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (STOCHASTIC) w = reinterpret_cast<const float4*>(urow)[v];
      c += static_cast<int>(fabsf(q.x) >= t) + (fabsf(q.y) >= t) +
           (fabsf(q.z) >= t) + (fabsf(q.w) >= t);
      reinterpret_cast<float4*>(orow)[v] = make_float4(
          masked_level<QUANT, STOCHASTIC>(q.x, w.x, t, s, qmax),
          masked_level<QUANT, STOCHASTIC>(q.y, w.y, t, s, qmax),
          masked_level<QUANT, STOCHASTIC>(q.z, w.z, t, s, qmax),
          masked_level<QUANT, STOCHASTIC>(q.w, w.w, t, s, qmax));
    }
    tail = n4 << 2;
  }
  for (long long i = tail + start; i < n; i += stride) {
    const float v = row[i];
    c += fabsf(v) >= t;
    orow[i] = masked_level<QUANT, STOCHASTIC>(v, STOCHASTIC ? urow[i] : 0.0f,
                                              t, s, qmax);
  }
  c = block_sum(c);
  if (threadIdx.x == 0 && c) atomicAdd(cnt + b, c);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

dim3 grid_for(long long n, int rows, long long per_block, long long budget) {
  long long want = (n + per_block - 1) / per_block;
  long long cap = budget / rows;
  if (cap < 1) cap = 1;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  return dim3(static_cast<unsigned>(want), static_cast<unsigned>(rows));
}

bool bad_shape(long long n, int rows) {
  return n <= 0 || rows <= 0 || rows > 65535;
}

template <int L>
void launch_bins(dim3 grid, cudaStream_t s, const float* x, const float* hi0,
                 int* part, long long n, int vec) {
  bin_partial_kernel<L><<<grid, kBinThreads, 0, s>>>(x, hi0, part, n, vec);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success).  The caller checks types, devices and contiguity, zeroes the
// count / max outputs, and passes n >= 1, 1 <= rows <= 65535.

extern "C" int threshold_count_f32(const void* x, const void* thr, void* cnt,
                                   long long n, int rows, void* stream) {
  if (bad_shape(n, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (n % 4 == 0) && aligned16(x);
  mask_count_kernel<false><<<grid_for(n, rows, kThreads * 4, kStreamBlocks),
                             kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr), nullptr,
      static_cast<int*>(cnt), n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int topk_mask_f32(const void* x, const void* thr, void* out,
                             void* cnt, long long n, int rows, void* stream) {
  if (bad_shape(n, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (n % 4 == 0) && aligned16(x) && aligned16(out);
  mask_count_kernel<true><<<grid_for(n, rows, kThreads * 4, kStreamBlocks),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr),
      static_cast<float*>(out), static_cast<int*>(cnt), n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int absmax_f32(const void* x, void* out, long long n, int rows,
                          void* stream) {
  if (bad_shape(n, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (n % 4 == 0) && aligned16(x);
  absmax_kernel<<<grid_for(n, rows, kThreads * 4, kStreamBlocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<unsigned*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// hist (rows, 2^levels) int32, fully written; scratch: rows * kBinParts *
// 2^levels int32 (the partial histograms).  Two kernels on `stream`.
extern "C" int bin_counts_f32(const void* x, const void* hi0, void* hist,
                              void* scratch, long long n, int rows,
                              int levels, void* stream) {
  if (bad_shape(n, rows) || levels < 1 || levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = (n % 4 == 0) && aligned16(x);
  long long parts = (n + kBinMinBlock - 1) / kBinMinBlock;
  if (parts > kBinParts) parts = kBinParts;
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(hi0);
  int* pf = static_cast<int*>(scratch);
  switch (levels) {
    case 1: launch_bins<1>(grid, s, xf, hf, pf, n, vec); break;
    case 2: launch_bins<2>(grid, s, xf, hf, pf, n, vec); break;
    case 3: launch_bins<3>(grid, s, xf, hf, pf, n, vec); break;
    case 4: launch_bins<4>(grid, s, xf, hf, pf, n, vec); break;
    case 5: launch_bins<5>(grid, s, xf, hf, pf, n, vec); break;
    case 6: launch_bins<6>(grid, s, xf, hf, pf, n, vec); break;
    case 7: launch_bins<7>(grid, s, xf, hf, pf, n, vec); break;
    case 8: launch_bins<8>(grid, s, xf, hf, pf, n, vec); break;
    case 9: launch_bins<9>(grid, s, xf, hf, pf, n, vec); break;
    case 10: launch_bins<10>(grid, s, xf, hf, pf, n, vec); break;
    case 11: launch_bins<11>(grid, s, xf, hf, pf, n, vec); break;
    default: launch_bins<12>(grid, s, xf, hf, pf, n, vec); break;
  }
  const int bins = 1 << levels;
  const cudaError_t rc = hopper::launch_dependent(
      bin_sum_kernel, dim3((bins + 31) / 32, rows), dim3(32 * kSumWarps), s,
      pf, static_cast<int*>(hist), static_cast<int>(parts), bins);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// bits == 0: mask and count only (u and scale unread).  bits in [2, 8]:
// quantize the survivors; u (rows, n) is read only when `stochastic`.
extern "C" int mask_quantize_f32(const void* x, const void* u, const void* thr,
                                 const void* scale, void* out, void* cnt,
                                 long long n, int rows, int bits,
                                 int stochastic, void* stream) {
  if (bad_shape(n, rows) || bits < 0 || bits == 1 || bits > 8 ||
      (stochastic && (bits == 0 || u == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = (n % 4 == 0) && aligned16(x) && aligned16(out) &&
                  (!stochastic || aligned16(u));
  const dim3 grid = grid_for(n, rows, kThreads * 4, kStreamBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = bits ? static_cast<float>((1 << (bits - 1)) - 1) : 0.0f;
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  const float* tf = static_cast<const float*>(thr);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  int* cf = static_cast<int*>(cnt);
  if (bits == 0) {
    mask_quantize_kernel<false, false><<<grid, kThreads, 0, s>>>(
        xf, nullptr, tf, sf, of, cf, n, qmax, vec);
  } else if (stochastic) {
    mask_quantize_kernel<true, true><<<grid, kThreads, 0, s>>>(
        xf, uf, tf, sf, of, cf, n, qmax, vec);
  } else {
    mask_quantize_kernel<true, false><<<grid, kThreads, 0, s>>>(
        xf, nullptr, tf, sf, of, cf, n, qmax, vec);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// pack: stream compaction of each row's survivors into a (cap,) buffer
// ---------------------------------------------------------------------------
//
// pack_batch_f32 (keep rule x != 0.0f as a float compare: -0.0 is dropped,
// NaN kept; the packed value is x) and mask_quantize_pack_f32 (keep rule
// |x| >= t: NaN dropped, +-inf kept; the packed value is the masked,
// quantized one, so a survivor that quantized to zero still takes a slot;
// it also writes the masked row, as mask_quantize_f32 does).  Survivor i
// of a row, counted in ascending index order, goes to slot i when i < cap;
// slots [min(total, cap), cap) hold (sentinel, 0.0f); the row's total is
// written even when it exceeds cap.  Counts, offsets and indices are
// int32: n < 2^31.
//
// The Pallas kernels carry the running offset across a sequential grid.
// CUDA blocks run in no order.  Both are bound by bytes on an H100:
// pack_batch must read x and write 8 B per slot (18.3 us at the Yi-9B
// vector and capacity 2,764,800); mask_quantize_pack also reads u and
// writes the masked row (41.8 us, 4-bit stochastic).
//
// One design serves both, each element read once: a scan kernel templated
// over its row source, then a fill (two kernels; the entry point zeroes the
// scratch on the stream):
//   1. pack_scan_kernel<Rows>: a block takes its tile of kPackTile elements
//      by a per-row ticket, in launch order, so every tile before it has
//      started.  Each warp walks its 512 elements a float4 chunk at a time
//      (16 elements a thread), the row source keeping kAhead chunks of loads
//      in flight: the source turns a chunk into the values to pack and their
//      keep bits and writes what else it writes at once (mask_quantize_pack:
//      the masked row, 16 bytes at a time, in flight while the tile waits
//      below); the warp ranks the chunk's survivors with ballots on the keep
//      bits and popc and stages (index, value), in order, in its own 512
//      slots of shared memory.  So no value outlives its chunk in
//      registers.  The block then publishes the tile's count, looks back
//      over its predecessors' 64-bit status words (flag and value written
//      together: aggregate, then inclusive prefix; one 128-byte line each,
//      so the look-backs of neighbouring tiles do not queue on one line) a
//      warp at a time, and publishes its inclusive prefix; each warp copies
//      its staged run to its slots with coalesced stores, 16 bytes wide
//      where the buffers allow.  A predecessor publishes its count before
//      it looks back itself, so no tile waits on one that has not started,
//      however many tiles a row has and however few are resident.  The last
//      tile writes the row's total.
//   2. pack_fill_kernel, a programmatic dependent launch: the empty slots,
//      16 bytes at a time where the buffers allow.
// Six blocks an SM (40 registers, 32 KiB of staging each) is as many as
// fit, and every instantiation keeps them with no spills.  The quantize
// arithmetic (an IEEE division an element) leaves little room: holding a
// tile's 16 levels in registers across a barrier spills, and so do two
// chunks of x and u in flight, so mask_quantize_pack stages chunk by chunk
// and, when stochastic, loads one chunk ahead.
// What holds it back on an H100 (PERF.md, PR 19): a tile's serial steps
// (ticket, load, look-back, copy-out) keep it resident after its loads
// have landed, so an SM has fewer bytes in flight than a plain streaming
// pass keeps; a tile waits some 3-4 us on its look-back.  Writing each
// tile's survivors to scratch first and placing them in a second kernel,
// with no waiting between blocks, is slower: it writes every survivor
// twice.

constexpr int kPackItems = 16;                     // elements per thread
constexpr int kPackTile = kThreads * kPackItems;   // 4096 elements per tile

namespace {

// The row sources of pack_scan_kernel.  row(b) points the source at row b.
// load(e) issues the loads of elements [e, e + 4) of the row (e % 4 == 0;
// those past n are not kept) as one Chunk; the kernel keeps kAhead chunks
// in flight.  values(c, e, v) puts the values to pack in v[0 .. 3], writes
// what else the source writes for them, and returns their keep bits (bit
// k: element e + k).  kept(v, keep, k) is element k's keep rule, from its
// value or its bit.  `vec`: n % 4 == 0 and every row buffer the source
// reads or writes 16-byte aligned.

// pack_batch: keep x != 0, pack x.  The keep rule reads the value, so no
// bits are carried; a tile's four chunks are loaded at once.
struct NonzeroRows {
  static constexpr int kAhead = 4;
  using Chunk = float4;
  const float* x;
  long long n;
  int vec;

  __device__ __forceinline__ void row(int b) { x += b * n; }

  __device__ __forceinline__ Chunk load(long long e) const {
    if (vec && e < n) {    // n % 4 == 0: the whole float4 is in the row
      return __ldg(reinterpret_cast<const float4*>(x + e));
    }
    return make_float4(e < n ? __ldg(x + e) : 0.0f,
                       e + 1 < n ? __ldg(x + e + 1) : 0.0f,
                       e + 2 < n ? __ldg(x + e + 2) : 0.0f,
                       e + 3 < n ? __ldg(x + e + 3) : 0.0f);
  }

  __device__ __forceinline__ unsigned values(const Chunk& c, long long,
                                             float* v) const {
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
    return 0u;
  }

  static __device__ __forceinline__ bool kept(float v, unsigned, int) {
    return v != 0.0f;
  }
};

// mask_quantize_pack: keep |x| >= t, pack the masked level (the device code
// of mask_quantize_kernel), write it to the masked row.  u is read only
// when STOCHASTIC, scale only when QUANT.  Within 40 registers two chunks
// fit in flight without u, one with it (two spill: PERF.md, PR 19).
template <bool QUANT, bool STOCHASTIC>
struct MaskQuantizeRows {
  static constexpr int kAhead = STOCHASTIC ? 1 : 2;
  struct Chunk {
    float x[4], u[4];
  };
  const float* x;
  const float* u;
  float* out;
  const float* thr;
  const float* scale;
  long long n;
  float qmax;
  int vec;
  float t = 0.0f, s = 1.0f;     // row(b): the row's threshold and scale

  __device__ __forceinline__ void row(int b) {
    x += b * n;
    if (STOCHASTIC) u += b * n;
    out += b * n;
    t = thr[b];
    s = QUANT ? scale[b] : 1.0f;
  }

  __device__ __forceinline__ Chunk load(long long e) const {
    Chunk c = {};
    if (vec && e < n) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + e));
      c.x[0] = q.x; c.x[1] = q.y; c.x[2] = q.z; c.x[3] = q.w;
      if (STOCHASTIC) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(u + e));
        c.u[0] = r.x; c.u[1] = r.y; c.u[2] = r.z; c.u[3] = r.w;
      }
      return c;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e + k < n) {
        c.x[k] = __ldg(x + e + k);
        if (STOCHASTIC) c.u[k] = __ldg(u + e + k);
      }
    }
    return c;
  }

  __device__ __forceinline__ unsigned values(const Chunk& c, long long e,
                                             float* v) const {
    const bool full = vec && e < n;
    unsigned keep = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = full || e + k < n;
      keep |= static_cast<unsigned>(in && fabsf(c.x[k]) >= t) << k;
      v[k] = in ? masked_level<QUANT, STOCHASTIC>(c.x[k], c.u[k], t, s, qmax)
                : 0.0f;
    }
    if (full) {
      *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e + k < n) out[e + k] = v[k];
      }
    }
    return keep;
  }

  static __device__ __forceinline__ bool kept(float, unsigned keep, int k) {
    return (keep >> k) & 1u;
  }
};

// a tile's status word: flag in the high 32 bits, count in the low 32; one
// word to a 128-byte line
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kStatusStride = 16;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// the exclusive prefix of tile t > 0 of a row, by warp 0: lane l reads the
// status of tile p - l, waiting until it is published; the window's counts
// up to the nearest inclusive prefix are summed, else the window moves 32
// tiles back.  Tiles before 0 count as an inclusive prefix of 0.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int t, int lane) {
  int excl = 0;
  for (int p = t - 1;; p -= 32) {
    const int k = p - lane;
    unsigned long long s = kInclusive;
    if (k >= 0) {
      do {
        s = load_status(status + static_cast<long long>(k) * kStatusStride);
      } while ((s >> 32) == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (inc) return excl;
  }
}

// pass 1 of both packs.  scratch: rows ticket words, then rows x ntiles
// status words kStatusStride apart, all zero at launch.  Warp w of a tile
// holds elements [tile + 512 w, tile + 512 (w + 1)): chunk r of 128, lane
// l's float4 at chunk + 4 l, so lane order is element order within a chunk.
// Warp w stages its survivors in slots [512 w, 512 (w + 1)) of s_idx and
// s_val.  `vec_out`: cap % 4 == 0 and idx, val 16-byte aligned.
template <class Rows>
__global__ void __launch_bounds__(kThreads, 6)
pack_scan_kernel(Rows rows, int* __restrict__ idx, float* __restrict__ val,
                 int* __restrict__ nnz,
                 unsigned long long* __restrict__ scratch, int ntiles,
                 int cap, int vec_out) {
  constexpr int kWarpItems = 32 * kPackItems;
  __shared__ int s_tile, s_prefix;
  __shared__ int warp_tot[kWarps];
  __shared__ int s_idx[kPackTile];
  __shared__ float s_val[kPackTile];
  hopper::pdl_launch_dependents();
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(scratch + b, 1ull));
  rows.row(b);
  __syncthreads();
  const int t = s_tile;
  const long long sub = static_cast<long long>(t) * kPackTile +
                        warp * kWarpItems;
  int* widx = s_idx + warp * kWarpItems;
  float* wval = s_val + warp * kWarpItems;
  // rank in chunk r's lane-major order: the warp's survivors of earlier
  // chunks, then those of lower lanes, then this lane's own lower elements
  const unsigned below = (1u << lane) - 1u;
  constexpr int kChunks = kPackItems / 4;
  typename Rows::Chunk ahead[Rows::kAhead];
#pragma unroll
  for (int r = 0; r < Rows::kAhead; ++r) {
    ahead[r] = rows.load(sub + 128 * r + 4 * lane);
  }
  int count = 0;
#pragma unroll
  for (int r = 0; r < kChunks; ++r) {
    const long long e = sub + 128 * r + 4 * lane;
    float v[4];
    const unsigned keep = rows.values(ahead[r % Rows::kAhead], e, v);
    int p = count;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m = __ballot_sync(0xffffffffu, Rows::kept(v[k], keep, k));
      p += __popc(m & below);
      count += __popc(m);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (Rows::kept(v[k], keep, k)) {
        widx[p] = static_cast<int>(e + k);
        wval[p] = v[k];
        ++p;
      }
    }
    if (r + Rows::kAhead < kChunks) {      // the slot is free again
      ahead[r % Rows::kAhead] = rows.load(e + 128 * Rows::kAhead);
    }
  }
  if (lane == 0) warp_tot[warp] = count;
  __syncthreads();
  if (warp == 0) {
    int agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) agg += warp_tot[w];
    unsigned long long* status = scratch + gridDim.y +
                                 static_cast<long long>(b) * ntiles *
                                     kStatusStride;
    int excl = 0;
    if (t == 0) {
      if (lane == 0) store_status(status, kInclusive | static_cast<unsigned>(agg));
    } else {
      if (lane == 0) {
        store_status(status + static_cast<long long>(t) * kStatusStride,
                     kAggregate | static_cast<unsigned>(agg));
      }
      excl = look_back(status, t, lane);
      if (lane == 0) {
        store_status(status + static_cast<long long>(t) * kStatusStride,
                     kInclusive | static_cast<unsigned>(excl + agg));
      }
    }
    if (lane == 0) {
      s_prefix = excl;
      if (t == ntiles - 1) nnz[b] = excl + agg;
    }
  }
  __syncthreads();
  // warp w's run to slots [start, start + count): a scalar head and tail,
  // the 4-aligned middle 16 bytes at a time
  int start = s_prefix;
  for (int w = 0; w < warp; ++w) start += warp_tot[w];
  if (start >= cap) return;
  const int end = start + min(count, cap - start);
  int* irow = idx + static_cast<long long>(b) * cap;
  float* orow = val + static_cast<long long>(b) * cap;
  int q0 = start, q1 = start;
  if (vec_out) {                           // cap % 4 == 0: no overflow here
    q0 = min((start + 3) & ~3, end);
    q1 = max(end & ~3, q0);
  }
  for (int i = start + lane; i < q0; i += 32) {
    irow[i] = widx[i - start];
    orow[i] = wval[i - start];
  }
  for (int i = q0 + 4 * lane; i < q1; i += 128) {
    const int k = i - start;
    *reinterpret_cast<int4*>(irow + i) =
        make_int4(widx[k], widx[k + 1], widx[k + 2], widx[k + 3]);
    *reinterpret_cast<float4*>(orow + i) =
        make_float4(wval[k], wval[k + 1], wval[k + 2], wval[k + 3]);
  }
  for (int i = max(q1, q0) + lane; i < end; i += 32) {
    irow[i] = widx[i - start];
    orow[i] = wval[i - start];
  }
}

// pass 2 of both packs: slots [min(nnz, cap), cap) of each row get
// (sentinel, 0); 16-byte stores when `vec` (cap % 4 == 0, both buffers
// 16-byte aligned)
__global__ void __launch_bounds__(kThreads)
pack_fill_kernel(const int* __restrict__ nnz, int* __restrict__ idx,
                 float* __restrict__ val, int cap, int sentinel, int vec) {
  hopper::pdl_wait();
  const int b = blockIdx.y;
  const int filled = min(nnz[b], cap);
  int* irow = idx + static_cast<long long>(b) * cap;
  float* orow = val + static_cast<long long>(b) * cap;
  const long long start = thread_start(), stride = thread_stride();
  if (vec) {
    const long long q0 = (static_cast<long long>(filled) + 3) >> 2;
    for (long long s = filled + start; s < 4 * q0 && s < cap; s += stride) {
      irow[s] = sentinel;
      orow[s] = 0.0f;
    }
    const int4 fill = make_int4(sentinel, sentinel, sentinel, sentinel);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long q = q0 + start; q < cap / 4; q += stride) {
      reinterpret_cast<int4*>(irow)[q] = fill;
      reinterpret_cast<float4*>(orow)[q] = zero;
    }
    return;
  }
  for (long long s = filled + start; s < cap; s += stride) {
    irow[s] = sentinel;
    orow[s] = 0.0f;
  }
}

bool bad_pack(long long n, int rows, int cap) {
  return bad_shape(n, rows) || n > 0x7fffffffLL || cap < 0;
}

int tiles_of(long long n) {
  return static_cast<int>((n + kPackTile - 1) / kPackTile);
}

// the two passes over `rows` (its source's rows of n elements) on `s`:
// zero the scratch, scan, fill
template <class Rows>
int launch_pack(const Rows& src, void* idx, void* val, void* nnz,
                void* scratch, long long n, int rows, int cap, int sentinel,
                cudaStream_t s) {
  const int nt = tiles_of(n);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t rc = cudaMemsetAsync(
      words, 0,
      sizeof(unsigned long long) * rows * (static_cast<long long>(nt) *
                                           kStatusStride + 1),
      s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int vec_out = (cap % 4 == 0) && aligned16(idx) && aligned16(val);
  pack_scan_kernel<Rows><<<dim3(nt, rows), kThreads, 0, s>>>(
      src, static_cast<int*>(idx), static_cast<float*>(val),
      static_cast<int*>(nnz), words, nt, cap, vec_out);
  if (cap > 0) {
    rc = hopper::launch_dependent(
        pack_fill_kernel, grid_for(cap, rows, kThreads * 16, kStreamBlocks),
        dim3(kThreads), s, static_cast<const int*>(nnz),
        static_cast<int*>(idx), static_cast<float*>(val), cap, sentinel,
        vec_out);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both packs: idx, val (rows, cap) int32 / f32, fully written; nnz / tot
// (rows,) int32, written; scratch: rows * (16 * ceil(n / 4096) + 1) 64-bit
// words, zeroed here.  One call = a memset and two kernels on `stream`.

// Pack each row of x (rows, n) with keep rule x != 0.
extern "C" int pack_batch_f32(const void* x, void* idx, void* val, void* nnz,
                              void* scratch, long long n, int rows, int cap,
                              int sentinel, void* stream) {
  if (bad_pack(n, rows, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const NonzeroRows src{static_cast<const float*>(x), n,
                        (n % 4 == 0) && aligned16(x)};
  return launch_pack(src, idx, val, nnz, scratch, n, rows, cap, sentinel,
                     static_cast<cudaStream_t>(stream));
}

// mask_quantize_f32 (same arguments and device code) that also packs the
// survivors, keep rule |x| >= thr[row]: out (rows, n) the masked row; tot
// the kept count.
extern "C" int mask_quantize_pack_f32(const void* x, const void* u,
                                      const void* thr, const void* scale,
                                      void* out, void* idx, void* val,
                                      void* tot, void* scratch, long long n,
                                      int rows, int bits, int stochastic,
                                      int cap, int sentinel, void* stream) {
  if (bad_pack(n, rows, cap) || bits < 0 || bits == 1 || bits > 8 ||
      (stochastic && (bits == 0 || u == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = bits ? static_cast<float>((1 << (bits - 1)) - 1) : 0.0f;
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  const float* tf = static_cast<const float*>(thr);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  const int vec = (n % 4 == 0) && aligned16(x) && aligned16(out) &&
                  (!stochastic || aligned16(u));
  if (bits == 0) {
    const MaskQuantizeRows<false, false> src{xf, nullptr, of, tf, sf, n, qmax,
                                             vec};
    return launch_pack(src, idx, val, tot, scratch, n, rows, cap, sentinel, s);
  }
  if (stochastic) {
    const MaskQuantizeRows<true, true> src{xf, uf, of, tf, sf, n, qmax, vec};
    return launch_pack(src, idx, val, tot, scratch, n, rows, cap, sentinel, s);
  }
  const MaskQuantizeRows<true, false> src{xf, nullptr, of, tf, sf, n, qmax,
                                          vec};
  return launch_pack(src, idx, val, tot, scratch, n, rows, cap, sentinel, s);
}
