// Mamba's selective scan for Hopper, sm_90a: the coefficients, the
// recurrence and the readout in one pass.
//
//   dt[b, t, d] = softplus(u[b, t, d] * w_dt[d] + dt_bias[d])
//   h[b, t, d, n] = exp(dt A[d, n]) h[b, t-1, d, n] + dt u[b, t, d] B[b, t, n]
//   y[b, t, d] = sum_n h[b, t, d, n] C[b, t, n] + D[d] u[b, t, d]
//
// with A = -exp(A_log) and h[b, -1] = h0[b] (zeros when none is given).
// u (B, S, di) bf16 or f32; w_dt (di, 1), dt_bias (di), A_log (di, N),
// D_skip (di), Bc and Cc (B, S, N), h0 (B, di, N) f32 -> y (B, S, di) and
// h_last (B, di, N) f32.  softplus is log(1 + e^x) written as
// max(x, 0) + log1p(e^-|x|), jax.nn.softplus's form.
//
// Replaces no Pallas kernel.  It is the port's counterpart of what XLA
// fuses in src/repro/models/ssm.py: `_ssm_coeffs` (the decay a and drive bu
// as (B, S, di, N) f32 tensors), `_chunk_scan` (jax.lax.associative_scan
// over them) and the readout of `mamba_forward_state`.  Eager PyTorch has
// no associative scan, and a loop over t issues about six kernels a token
// a layer (1.6 M launches for one 8192-token hymba-1.5b prefill); the
// (B, S, di, N) tensors are 1.68 GB each a layer there.  This kernel never
// writes them: h lives in a register for the whole sequence.  Decode is
// the same kernel at S = 1 with h0 the lane's state.
//
// What bounds it on an H100: one exp and 4 FMA-pipe ops (dt A, (dt u) B,
// h's and h C's multiply-adds) a (t, d, n), B S di N of them (4.19e8 at
// hymba-1.5b's 8192-token prefill, di 3200, N 16).  The special function
// units give 16 exps a clock an SM and the FMA pipes 128 ops; with a third
// of the exps computed on the FMA pipes as a polynomial (4 ops) both
// finish at 1/24 clock an element: about 67 us at 1.98 GHz (100 us on the
// special function units alone).  The bytes, u read and y written once
// (157 MB in bf16, 210 MB in f32), take 47-63 us at 3.35 TB/s.
//
// Design (simple first): one thread per (b, d, n).  A block of 128 threads
// holds CH = 128 / N channels of one batch row; lanes n of a channel are
// N neighbouring lanes of one warp.  The block walks t in chunks of 64
// steps: it first stages, per step, (dt, dt u) and D u for its CH channels
// and (B_t, C_t) in shared memory (dt computed once per (t, d), not per
// lane), then every thread steps its h through the chunk, N steps at a
// time: the N products h C of each step stay in registers, and one
// reduce-scatter over the N lanes (N - 1 shuffles for N steps, not
// N log2 N) leaves step j's sum on lane j, which adds it to D u in shared
// memory.  The chunk's y is then written back, a row of CH floats per
// step.  Steps past S are staged as dt = 0 (a = 1, no drive) and never
// written.  The only dependence between steps is h's multiply-add, so the
// unrolled loop keeps the next steps' loads and exps in flight.  Filling
// the card with a chunked two-pass scan (h of each chunk from the chunk's
// own start, then a pass that carries the starts) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;                     // steps staged per pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Sums p[j] over the O * 2 lanes of a channel for every j, halving the
// values a lane holds at each level: after the levels O, O / 2, ..., 1,
// lane n's p[0] holds step n's sum (n - 1 shuffles for n steps).
template <int O, int N>
__device__ __forceinline__ void reduce_scatter(float (&p)[N], int n) {
  const bool up = (n & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = up ? p[k] : p[k + O];
    const float keep = up ? p[k + O] : p[k];
    p[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) reduce_scatter<O / 2>(p, n);
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ u, const float* __restrict__ w_dt,
    const float* __restrict__ dt_bias, const float* __restrict__ A_log,
    const float* __restrict__ D_skip, const float* __restrict__ Bc,
    const float* __restrict__ Cc, const float* h0, float* __restrict__ y,
    float* h_last, int S, int di) {
  constexpr int CH = kThreads / N;             // channels a block
  static_assert(kChunk % N == 0 && (N & (N - 1)) == 0 && N <= 32, "N");
  __shared__ float2 s_dt[kChunk][CH];          // (dt, dt u)
  __shared__ float2 s_bc[kChunk][N];           // (B_t, C_t)
  __shared__ float s_y[kChunk][CH];            // D u, then + sum_n h C

  const int tid = threadIdx.x;
  const int c = tid / N;
  const int n = tid % N;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < di;
  // exp(dt A) as exp2(dt A log2 e)
  const float A2 = live ? -expf(A_log[static_cast<size_t>(d) * N + n]) * kLog2e
                        : 0.f;
  const size_t hrow = (static_cast<size_t>(b) * di + d) * N + n;
  float h = (live && h0 != nullptr) ? h0[hrow] : 0.f;
  const size_t urow = static_cast<size_t>(b) * S;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    __syncthreads();                           // the last chunk is written
    for (int i = tid; i < kChunk * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, t = t0 + tt, dd = d0 + cc;
      float dtv = 0.f, dtu = 0.f, du = 0.f;
      if (t < S && dd < di) {
        const float uv = to_f32(u[(urow + t) * di + dd]);
        dtv = softplus(uv * w_dt[dd] + dt_bias[dd]);
        dtu = dtv * uv;
        du = D_skip[dd] * uv;
      }
      s_dt[tt][cc] = make_float2(dtv, dtu);
      s_y[tt][cc] = du;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int tt = i / N, nn = i % N, t = t0 + tt;
      float bv = 0.f, cv = 0.f;
      if (t < S) {
        const size_t o = (urow + t) * N + nn;
        bv = Bc[o];
        cv = Cc[o];
      }
      s_bc[tt][nn] = make_float2(bv, cv);
    }
    __syncthreads();
    const int steps = min(kChunk, S - t0);
    for (int g = 0; g < steps; g += N) {
      float p[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float2 dv = s_dt[g + j][c];
        const float2 bc = s_bc[g + j][n];
        const float a = exp2f(dv.x * A2);
        h = fmaf(a, h, dv.y * bc.x);
        p[j] = h * bc.y;
      }
      reduce_scatter<N / 2>(p, n);
      if (live && g + n < steps) s_y[g + n][c] += p[0];
    }
    __syncthreads();
    for (int i = tid; i < steps * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, dd = d0 + cc;
      if (dd < di) y[(urow + t0 + tt) * di + dd] = s_y[tt][cc];
    }
  }
  if (live) h_last[hrow] = h;
}

template <int N, typename T>
void launch(dim3 grid, cudaStream_t s, const void* u, const float* w_dt,
            const float* dt_bias, const float* A_log, const float* D_skip,
            const float* Bc, const float* Cc, const float* h0, float* y,
            float* h_last, int S, int di) {
  selective_scan_kernel<N, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u), w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0, y,
      h_last, S, di);
}

}  // namespace

// dtype: 0 bf16, 1 f32 (u's).  h0 may be null (zeros); h_last may be h0
// (each thread reads its h0 element before it writes the same element).
extern "C" int selective_scan_fwd(const void* u, const void* w_dt,
                                  const void* dt_bias, const void* A_log,
                                  const void* D_skip, const void* Bc,
                                  const void* Cc, const void* h0, void* y,
                                  void* h_last, int B, int S, int di, int N,
                                  int dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || (N != 8 && N != 16) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ch = kThreads / N;
  const dim3 grid((di + ch - 1) / ch, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w_dt);
  const float* bias = static_cast<const float*>(dt_bias);
  const float* al = static_cast<const float*>(A_log);
  const float* ds = static_cast<const float*>(D_skip);
  const float* bc = static_cast<const float*>(Bc);
  const float* cc = static_cast<const float*>(Cc);
  const float* hi = static_cast<const float*>(h0);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_last);
  if (N == 16) {
    if (dtype == 0) {
      launch<16, __nv_bfloat16>(grid, s, u, w, bias, al, ds, bc, cc, hi, yo,
                                ho, S, di);
    } else {
      launch<16, float>(grid, s, u, w, bias, al, ds, bc, cc, hi, yo, ho, S,
                        di);
    }
  } else {
    if (dtype == 0) {
      launch<8, __nv_bfloat16>(grid, s, u, w, bias, al, ds, bc, cc, hi, yo,
                               ho, S, di);
    } else {
      launch<8, float>(grid, s, u, w, bias, al, ds, bc, cc, hi, yo, ho, S,
                       di);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
