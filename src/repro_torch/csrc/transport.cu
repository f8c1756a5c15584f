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
//   fused_transport.py::fused_mask_quantize_pallas -> mask_quantize_f32
//   fused_transport.py::fused_mask_quantize_pack_pallas
//                                             -> mask_quantize_pack_f32
//   fused_transport.py::pack_values_batched_pallas -> pack_batch_f32
//       (the two pack kernels: see "pack" below)
//
// What bounds them on an H100: each is one streaming pass over the rows
// with a handful of operations per element, far below the f32 rate, so all
// five are bound by bytes at 3.35 TB/s.  At the Yi-9B LoRA vector
// (n = 9,830,400 f32, 39.3 MB a row): absmax and threshold_count read a row
// once (11.7 us); bin_counts reads it once and does ~60 f32 operations per
// element (12 bisection steps), still bytes-bound (12 us); topk_mask reads
// and writes a row (23.5 us); mask_quantize reads x and the uniform draw u
// and writes the result (35 us a row, 141 us for 4 clients).
//
// Design (first version: right and simple):
//   - grid (blocks over the row, rows); each thread strides over its row,
//     16-byte float4 loads and stores where the row is 16-byte aligned and
//     n % 4 == 0, scalar loads otherwise (and for the ragged tail).  Enough
//     blocks run to keep every SM streaming.
//   - cross-block results combine with order-free atomics, so every result
//     is exact and bitwise reproducible: integer adds for counts and bins,
//     an unsigned max on the bits of |x| for absmax (non-negative floats
//     order as their bit patterns).  The wrapper zeroes the outputs first.
//   - bin_counts keeps a 2^L-bin int histogram (16 KiB at L = 12) in shared
//     memory per block, counts into it with shared atomics, and flushes only
//     the non-zero bins with global atomics.  Fewer, larger blocks keep the
//     flush cheap.
//   - the ragged tail is masked, never padded: unlike the Pallas version no
//     pad zeros land in bin 0.  No threshold ever reads bin 0.
//   - arithmetic is op for op the reference's, with IEEE rounding spelled
//     out (__fadd_rn, __fmul_rn, __fdiv_rn) so that no contraction or fast
//     path changes a bit: mid = 0.5f * (lo + hi); y = x / scale; floor(y + u)
//     or rint(y) (half to even); clip to [-qmax - 1, qmax]; y * scale.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 12;
// blocks in flight over all rows: 16 per SM for the streaming passes,
// 8 per SM for bin_counts (each flushes a histogram)
constexpr long long kStreamBlocks = 132 * 16;
constexpr long long kBinBlocks = 132 * 8;

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
// bin_counts<L>: histogram of the L-step bisection path of every |x|
// ---------------------------------------------------------------------------

template <int L>
__device__ __forceinline__ int bisection_bin(float v, float top) {
  const float a = fabsf(v);
  float lo = 0.0f, hi = top;
  int idx = 0;
#pragma unroll
  for (int d = 0; d < L; ++d) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool up = a >= mid;
    idx = 2 * idx + static_cast<int>(up);
    lo = up ? mid : lo;
    hi = up ? hi : mid;
  }
  return idx;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
bin_counts_kernel(const float* __restrict__ x, const float* __restrict__ hi0,
                  int* __restrict__ hist, long long n, int vec) {
  __shared__ int h[1 << L];
  for (int i = threadIdx.x; i < (1 << L); i += kThreads) h[i] = 0;
  __syncthreads();
  const int b = blockIdx.y;
  const float* row = x + b * n;
  const float top = hi0[b];
  const long long start = thread_start(), stride = thread_stride();
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (long long v = start; v < n4; v += stride) {
      const float4 q = r4[v];
      atomicAdd(&h[bisection_bin<L>(q.x, top)], 1);
      atomicAdd(&h[bisection_bin<L>(q.y, top)], 1);
      atomicAdd(&h[bisection_bin<L>(q.z, top)], 1);
      atomicAdd(&h[bisection_bin<L>(q.w, top)], 1);
    }
    tail = n4 << 2;
  }
  for (long long i = tail + start; i < n; i += stride) {
    atomicAdd(&h[bisection_bin<L>(row[i], top)], 1);
  }
  __syncthreads();
  int* out = hist + (static_cast<long long>(b) << L);
  for (int i = threadIdx.x; i < (1 << L); i += kThreads) {
    const int c = h[i];
    if (c) atomicAdd(out + i, c);
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
  y = fminf(fmaxf(y, -qmax - 1.0f), qmax);
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
                 int* hist, long long n, int vec) {
  bin_counts_kernel<L><<<grid, kThreads, 0, s>>>(x, hi0, hist, n, vec);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success).  The caller checks types, devices and contiguity, zeroes the
// count / max / histogram outputs, and passes n >= 1, 1 <= rows <= 65535.

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

extern "C" int bin_counts_f32(const void* x, const void* hi0, void* hist,
                              long long n, int rows, int levels,
                              void* stream) {
  if (bad_shape(n, rows) || levels < 1 || levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = (n % 4 == 0) && aligned16(x);
  const dim3 grid = grid_for(n, rows, kThreads * 16, kBinBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(hi0);
  int* hi = static_cast<int*>(hist);
  switch (levels) {
    case 1: launch_bins<1>(grid, s, xf, hf, hi, n, vec); break;
    case 2: launch_bins<2>(grid, s, xf, hf, hi, n, vec); break;
    case 3: launch_bins<3>(grid, s, xf, hf, hi, n, vec); break;
    case 4: launch_bins<4>(grid, s, xf, hf, hi, n, vec); break;
    case 5: launch_bins<5>(grid, s, xf, hf, hi, n, vec); break;
    case 6: launch_bins<6>(grid, s, xf, hf, hi, n, vec); break;
    case 7: launch_bins<7>(grid, s, xf, hf, hi, n, vec); break;
    case 8: launch_bins<8>(grid, s, xf, hf, hi, n, vec); break;
    case 9: launch_bins<9>(grid, s, xf, hf, hi, n, vec); break;
    case 10: launch_bins<10>(grid, s, xf, hf, hi, n, vec); break;
    case 11: launch_bins<11>(grid, s, xf, hf, hi, n, vec); break;
    default: launch_bins<12>(grid, s, xf, hf, hi, n, vec); break;
  }
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
// NaN kept) and mask_quantize_pack_f32 (keep rule |x| >= t; the packed value
// is the masked, quantized one, so a survivor that quantized to zero still
// takes a slot).  Survivor i of a row, counted in ascending index order,
// goes to slot i when i < cap; slots [min(total, cap), cap) hold
// (sentinel, 0.0f); the row's total is written even when it exceeds cap.
//
// The Pallas kernels carry the running offset across a sequential grid.
// CUDA blocks run in no order, so each entry point launches three kernels
// on its stream, all over one fixed tiling (tile j of a row is elements
// [j * kPackTile, (j + 1) * kPackTile), one block per tile):
//   1. count: the keep count of every tile (mask_quantize_pack also writes
//      the masked, quantized row here, with mask_quantize's device code);
//   2. scan: one block per row turns the tile counts into exclusive
//      offsets in place and writes the row total;
//   3. scatter: each block recomputes its keep mask, ranks its survivors
//      with a warp ballot / popc and a prefix over the block's warps, and
//      writes (index, value) at row offset + rank when that is < cap; then
//      the row's blocks fill the empty slots.
// Bound by bytes on an H100: pack_batch reads x and writes 8 B per slot;
// mask_quantize_pack reads x (and u) and writes the masked row and the
// slots.  This design reads x twice (and the masked row once more), so
// it needs about 1.5-2x the bytes of its bound.  Counts, offsets and
// indices are int32: n < 2^31.

constexpr int kPackItems = 16;                     // elements per thread
constexpr int kPackTile = kThreads * kPackItems;   // 4096 elements per tile
constexpr int kScanThreads = 1024;

namespace {

__global__ void __launch_bounds__(kThreads)
pack_count_kernel(const float* __restrict__ x, int* __restrict__ counts,
                  long long n, int ntiles) {
  const int b = blockIdx.y, j = blockIdx.x;
  const float* row = x + b * n;
  const long long base = static_cast<long long>(j) * kPackTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kPackItems; ++r) {
    const long long e = base + r * kThreads + threadIdx.x;
    if (e < n) c += row[e] != 0.0f;
  }
  c = block_sum(c);
  if (threadIdx.x == 0) counts[static_cast<long long>(b) * ntiles + j] = c;
}

template <bool QUANT, bool STOCHASTIC>
__global__ void __launch_bounds__(kThreads)
mask_quantize_tile_kernel(const float* __restrict__ x,
                          const float* __restrict__ u,
                          const float* __restrict__ thr,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int* __restrict__ counts,
                          long long n, int ntiles, float qmax) {
  const int b = blockIdx.y, j = blockIdx.x;
  const float* row = x + b * n;
  const float* urow = STOCHASTIC ? u + b * n : nullptr;
  float* orow = out + b * n;
  const float t = thr[b];
  const float s = QUANT ? scale[b] : 1.0f;
  const long long base = static_cast<long long>(j) * kPackTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kPackItems; ++r) {
    const long long e = base + r * kThreads + threadIdx.x;
    if (e < n) {
      const float v = row[e];
      c += fabsf(v) >= t;
      orow[e] = masked_level<QUANT, STOCHASTIC>(
          v, STOCHASTIC ? urow[e] : 0.0f, t, s, qmax);
    }
  }
  c = block_sum(c);
  if (threadIdx.x == 0) counts[static_cast<long long>(b) * ntiles + j] = c;
}

// exclusive scan of one row's tile counts, in place; total -> tot[row]
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int* __restrict__ counts, int* __restrict__ tot,
                  int ntiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = counts + static_cast<long long>(blockIdx.x) * ntiles;
  int carry = 0;
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? row[i] : 0;
    int s = v;                                   // inclusive, in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane == 31) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {                             // inclusive over the warps
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (i < ntiles) row[i] = carry + (warp ? warp_sums[warp - 1] : 0) + s - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();                             // warp_sums is reused
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = carry;
}

// NONZERO: keep x != 0, pack x (pack_batch).  Else keep |x| >= thr[row],
// pack vals (the masked row that mask_quantize_tile_kernel wrote).
template <bool NONZERO>
__global__ void __launch_bounds__(kThreads)
pack_scatter_kernel(const float* __restrict__ x,
                    const float* __restrict__ vals,
                    const float* __restrict__ thr,
                    const int* __restrict__ offsets,
                    const int* __restrict__ tot, int* __restrict__ idx,
                    float* __restrict__ val, long long n, int ntiles, int cap,
                    int sentinel) {
  __shared__ int warp_tot[kWarps];
  const int b = blockIdx.y, j = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = x + b * n;
  const float* vrow = NONZERO ? row : vals + b * n;
  const float t = NONZERO ? 0.0f : thr[b];
  int* irow = idx + static_cast<long long>(b) * cap;
  float* orow = val + static_cast<long long>(b) * cap;
  // warp w ranks elements [sub, sub + 32 * kPackItems) of the tile, in
  // ascending order: element sub + 32 * r + lane is its (r, lane)-th
  const long long sub = static_cast<long long>(j) * kPackTile +
                        warp * (32 * kPackItems);
  unsigned masks[kPackItems];
  int count = 0;
#pragma unroll
  for (int r = 0; r < kPackItems; ++r) {
    const long long e = sub + 32 * r + lane;
    bool keep = false;
    if (e < n) {
      const float v = row[e];
      keep = NONZERO ? (v != 0.0f) : (fabsf(v) >= t);
    }
    masks[r] = __ballot_sync(0xffffffffu, keep);
    count += __popc(masks[r]);
  }
  if (lane == 0) warp_tot[warp] = count;
  __syncthreads();
  int rank = offsets[static_cast<long long>(b) * ntiles + j];
  for (int w = 0; w < warp; ++w) rank += warp_tot[w];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kPackItems; ++r) {
    const unsigned m = masks[r];
    if ((m >> lane) & 1u) {
      const int pos = rank + __popc(m & below);
      if (pos < cap) {
        const long long e = sub + 32 * r + lane;
        irow[pos] = static_cast<int>(e);
        orow[pos] = vrow[e];
      }
    }
    rank += __popc(m);
  }
  const int filled = min(tot[b], cap);
  for (long long s = filled + static_cast<long long>(j) * kThreads +
                     threadIdx.x;
       s < cap; s += static_cast<long long>(gridDim.x) * kThreads) {
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

}  // namespace

// Pack each row of x (rows, n) with keep rule x != 0.  idx, val: (rows, cap)
// int32 / f32, fully written; nnz: (rows,) int32; scratch: (rows,
// ceil(n / 4096)) int32.  One call = three kernels on `stream`.
extern "C" int pack_batch_f32(const void* x, void* idx, void* val, void* nnz,
                              void* scratch, long long n, int rows, int cap,
                              int sentinel, void* stream) {
  if (bad_pack(n, rows, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = tiles_of(n);
  const dim3 grid(nt, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(scratch);
  pack_count_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                              counts, n, nt);
  scan_tiles_kernel<<<rows, kScanThreads, 0, s>>>(counts,
                                                  static_cast<int*>(nnz), nt);
  pack_scatter_kernel<true><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), nullptr, nullptr, counts,
      static_cast<const int*>(nnz), static_cast<int*>(idx),
      static_cast<float*>(val), n, nt, cap, sentinel);
  return static_cast<int>(cudaGetLastError());
}

// mask_quantize_f32 (same arguments and device code) that also packs the
// survivors: out (rows, n) masked row; idx, val (rows, cap) fully written;
// tot (rows,) int32 kept count; scratch (rows, ceil(n / 4096)) int32.
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
  const int nt = tiles_of(n);
  const dim3 grid(nt, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = bits ? static_cast<float>((1 << (bits - 1)) - 1) : 0.0f;
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  const float* tf = static_cast<const float*>(thr);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  int* counts = static_cast<int*>(scratch);
  if (bits == 0) {
    mask_quantize_tile_kernel<false, false><<<grid, kThreads, 0, s>>>(
        xf, nullptr, tf, sf, of, counts, n, nt, qmax);
  } else if (stochastic) {
    mask_quantize_tile_kernel<true, true><<<grid, kThreads, 0, s>>>(
        xf, uf, tf, sf, of, counts, n, nt, qmax);
  } else {
    mask_quantize_tile_kernel<true, false><<<grid, kThreads, 0, s>>>(
        xf, nullptr, tf, sf, of, counts, n, nt, qmax);
  }
  scan_tiles_kernel<<<rows, kScanThreads, 0, s>>>(counts,
                                                  static_cast<int*>(tot), nt);
  pack_scatter_kernel<false><<<grid, kThreads, 0, s>>>(
      xf, of, tf, counts, static_cast<const int*>(tot),
      static_cast<int*>(idx), static_cast<float*>(val), n, nt, cap, sentinel);
  return static_cast<int>(cudaGetLastError());
}
