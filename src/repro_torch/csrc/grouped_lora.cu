// Grouped multi-adapter LoRA delta (multi-tenant BGMV) for Hopper, sm_90a.
//
//   out[m, n] = scale * sum_r (sum_k x[m, k] * a[g[m], k, r]) * b[g[m], r, n]
//
// x (M, K), a (G, K, R), b (G, R, N) f32, g = gidx (M,) int32 -> out (M, N) f32.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py::
// PallasGroupedKernel.delta / _grouped_kernel: row m's (K, R) and (R, N)
// pages are read straight out of the page pools by index, so the (M, K, R)
// gather is never materialized.  Two contractions per row, both accumulated
// in f32, scale applied to the second (the contract of
// GroupedLoraKernel in that file).  Any M, K, N; the ragged N edge is masked
// (the Pallas version zero-pads N instead).
//
// What bounds it on an H100: at the serving decode shapes (M = lanes ~ 8,
// K = 4096, R = 16, N in {4096, 512}, G = pages ~ 4) one launch must move
// x, the distinct a and b pages and the output, about 2-4 MB: ~1 us at
// 3.35 TB/s, and ~2 MFLOP, far below the f32 rate.  So a launch is bound by
// its latency, and decode launches it 4 times per layer (wq, wk, wv, wo):
// 192 times a step for a 48-layer model, against a backbone weight read of
// ~5.3 ms a step (17.7 GB of bf16 weights at 3.35 TB/s).
//
// Design (first version: right and simple; speed is later work):
//   grid (M, ceil(N / kBlockN)), kThreads threads a block.
//   Phase 1: the block reduces x[m, :] . a[g, :, r] over K for all R ranks
//     into xa[R] in shared memory: each thread keeps R f32 partials over a
//     strided K range (one contiguous R-float row of a per k), then a warp
//     shuffle reduction and a cross-warp sum.
//   Phase 2: each thread writes scale * sum_r xa[r] * b[g, r, n] for its n;
//     neighbouring threads read neighbouring n of each b row (coalesced).
// Known cost: phase 1 is recomputed by every N tile of a row (16 times for
// N = 4096); the a page then comes from L2 after the first tile.
//
// Ranks up to 64 are supported (R is bucketed to a compile-time bound for
// the register partials); the wrapper raises above that.  A page index
// outside [0, G) is clamped, so a bad index cannot read outside the pool.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = kThreads;   // one output column per thread

template <int RB>
__global__ void __launch_bounds__(kThreads)
grouped_lora_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ b, const int* __restrict__ gidx,
                    float* __restrict__ out, int K, int R, int N, int G,
                    float scale) {
  __shared__ float red[kWarps][RB];
  __shared__ float xa[RB];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  int g = gidx[m];
  g = g < 0 ? 0 : (g >= G ? G - 1 : g);
  const float* xr = x + static_cast<size_t>(m) * K;
  const float* ap = a + static_cast<size_t>(g) * K * R;
  const float* bp = b + static_cast<size_t>(g) * R * N;

  // Phase 1: xa[r] = sum_k x[m, k] * a[g, k, r], f32.
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
  for (int k = tid; k < K; k += kThreads) {
    const float xv = xr[k];
    const float* arow = ap + static_cast<size_t>(k) * R;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) acc[r] = fmaf(xv, arow[r], acc[r]);
    }
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp][r] = v;
  }
  __syncthreads();
  if (tid < R) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    xa[tid] = s;
  }
  __syncthreads();

  // Phase 2: out[m, n] = scale * sum_r xa[r] * b[g, r, n], f32.
  const int n = blockIdx.y * kBlockN + tid;
  if (n < N) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) {
      s = fmaf(xa[r], bp[static_cast<size_t>(r) * N + n], s);
    }
    out[static_cast<size_t>(m) * N + n] = scale * s;
  }
}

template <int RB>
void launch(dim3 grid, cudaStream_t stream, const float* x, const float* a,
            const float* b, const int* gidx, float* out, int K, int R, int N,
            int G, float scale) {
  grouped_lora_kernel<RB><<<grid, kThreads, 0, stream>>>(x, a, b, gidx, out,
                                                         K, R, N, G, scale);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, types, devices and contiguity; M, N > 0, G >= 1.
extern "C" int grouped_lora_delta_f32(const void* x, const void* a,
                                      const void* b, const void* gidx,
                                      void* out, int M, int K, int R, int N,
                                      int G, float scale, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0 || R < 0 || R > 64 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(M, (N + kBlockN - 1) / kBlockN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int* gi = static_cast<const int*>(gidx);
  float* of = static_cast<float*>(out);
  if (R <= 8) {
    launch<8>(grid, s, xf, af, bf, gi, of, K, R, N, G, scale);
  } else if (R <= 16) {
    launch<16>(grid, s, xf, af, bf, gi, of, K, R, N, G, scale);
  } else if (R <= 32) {
    launch<32>(grid, s, xf, af, bf, gi, of, K, R, N, G, scale);
  } else {
    launch<64>(grid, s, xf, af, bf, gi, of, K, R, N, G, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
