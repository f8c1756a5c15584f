// Mamba's selective scan for Hopper, sm_90a: the coefficients, the
// recurrence and the readout.
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
// (B, S, di, N) tensors are 1.68 GB each a layer there.  These kernels
// never write them: h lives in registers.
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
// Design: a chunked scan, the reference's own decomposition
// (src/repro/models/ssm.py:75-84, :103-112: chunks of L steps, a local
// scan from zero, then h = s + a h0).  One thread owns one channel (b, d)
// and all N of its states, so the N states are N independent multiply-add
// chains in one thread (no shuffles), dt is computed once per (t, d) by
// the thread that uses it, and a warp reads u and writes y as 32
// neighbouring channels.  B_t and C_t, the same for every channel, are
// staged a chunk at a time in shared memory by cp.async (two groups: the
// first 32 steps are scanned while the rest land) and read as broadcasts;
// u is read from HBM kAhead steps ahead into registers.  The arithmetic is
// in log2 units: s = softplus(x) log2 e by one ex2 and a polynomial
// (softplus_log2), so that the decay exp(dt A) is exp2(s A) and the drive
// dt u is s (u ln 2).  Three kernels when S > L (one launch of the entry
// point; L = kChunk, which kernels/selective_scan.py::CHUNK mirrors):
//   1. selective_scan_chunk_kernel, grid (channel blocks, chunks 0 .. nc-2,
//      B): steps h through its chunk from zero and writes only the end
//      state s_c and the chunk's sum of s (its decay is exp2(A sum s): one
//      exp a chunk, the product of the steps' decays).  No readout.
//   2. selective_scan_carry_kernel, one thread per (b, d, n): H = h0, then
//      in chunk order H_c = exp2(A sum_c s) H_{c-1} + s_c, each chunk's
//      start state written over its s_c (a fixed order: two launches are
//      bitwise equal; no atomics anywhere).
//   3. selective_scan_kernel, grid (channel blocks, chunks, B): rescans each
//      chunk from its start state with the readout and the y write; the
//      last chunk writes h_last.
// At S <= L (decode: S = 1) only kernel 3 runs, from h0 itself, and
// h_last may be h0 (each thread reads its states before it writes them).
// At hymba's 8192-token prefill (B 1, di 3200, L 192) the grid holds 25
// channel blocks x 43 chunks; kernels 1 and 3 are about equal halves of
// the time, kernel 2 about 2%.  The price of the two passes is two exps an
// element against the bound's one: the special function units alone allow
// about 200 us there.  Measured on an H100 and dropped (PERF.md §6, row 11):
// two or four of the 16 exps of a step on the FMA pipes as a polynomial
// (slower, and 4x the error: the kernels issue as much as they exp), two threads a
// channel (more warps, slower prefill), expf + log1pf for softplus, 8 steps
// of u ahead, chunk lengths that fill whole waves of blocks, and L 64,
// 128, 224, 256, 320 and 416 (192 is the fastest at hymba's 8192-token
// prefill; 416 is 3% faster at 32768 tokens and 5% slower at 8192).
//
// The backward (selective_scan_bwd, at the end of the file): given dy (B,
// S, di) and dh_last (B, di, N) f32 (either may be zero) it returns du (in
// u's dtype, summed in f32 and rounded once), dBc and dCc (B, S, N), dh0
// and the per-channel sums dw_dt, ddt_bias, dA_log and dD_skip.  With a_t =
// exp(dt_t A) and the adjoint g_t = dL/dh_t = a_{t+1} g_{t+1} + C_t dy_t
// (from dh_last): dBc = sum_d g dt u, dCc = sum_d h_t dy_t, d(dt) = sum_n g
// (A a_t h_{t-1} + u B_t), dA = sum_t g dt a_t h_{t-1}, du = D dy + dt
// sum_n g B + w_dt d(dt) sigmoid(x).  What bounds it: one exp and 11
// FMA-pipe ops an element (h_t again: dt A, ah = a h_{t-1}, fma(dt u, B,
// ah); g: g a, fma(C, dy, .); g ah, shared by d(dt) and dA; then one fma
// each for dB, dC, dA, d(dt) and sum_n g B, each sum taken into its
// product), B S di N of them: 11/128 clock an element on the FMA pipes,
// about 138 us at hymba-1.5b's 8192 tokens.  The
// adjoint is the forward's recurrence run backward, so it takes the same
// decomposition in reverse, five kernels in one launch of the entry point:
//   1. selective_scan_bwd_chunk_kernel, chunks 1 .. nc - 1: each chunk's
//      adjoint from zero at its start, g = (g + C dy) a back to its first
//      step, and its sum of s (the forward's scratch has none for the last
//      chunk).
//   2. selective_scan_bwd_carry_kernel, one thread per (b, d, n): G =
//      dh_last, then in reverse chunk order each chunk's incoming adjoint
//      written, G = l_c + exp2(A sum_c s) G.
//   3. selective_scan_bwd_kernel, grid (channel blocks, chunks, B), N / 4
//      threads a channel, four states a thread: the chunk again from its
//      start state (the forward's scratch, which it keeps for this: the
//      (B, S, di, N) states are never written), the state at every kSub-th
//      step kept in shared memory; then each sub-chunk, last first,
//      rescanned from its checkpoint with h_{t-1}, s, u and dy kept in
//      registers, and walked backward with the adjoint forming every
//      gradient.  h is never inverted (a_t underflows to 0 at large dt
//      |A|).  A channel's sums over its states take 2 or 3 shuffles a step;
//      dBc and dCc sum over the warp's channels by a transposing butterfly
//      (7 shuffles for 8 values), then over the block's warps in shared
//      memory, into per-block partials.
//   4. selective_scan_bwd_sum_kernel: the partials of dBc and dCc summed
//      over the blocks in block order.
//   5. selective_scan_bwd_param_kernel (when the caller asks for them): the
//      per-chunk sums of dA, dw_dt, ddt_bias and dD_skip over (b, chunk) in
//      order.
// No atomics: two launches are bitwise equal.  Four exps an element
// (kernel 1, kernel 3's two passes and its backward walk) against the
// bound's one.  Measured on an H100 and replaced (PERF.md §6, row 11b): the
// first version held a channel's 16 states in one thread, as the forward
// does, which left no registers for a sub-chunk's history: kept in 64 KB
// of shared memory a warp, it ran three warps an SM, 2.74 ms for kernel 3
// at hymba-1.5b's 8192 tokens.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                  // channels a block
// L, steps a chunk.  It reaches kernels 1 and 3 as an argument, with their
// shared memory sized at launch: as a compile-time constant in them nvcc
// scheduled the rescan 3-5% slower on an H100 (PERF.md §6, row 11).
constexpr int kChunk = 192;
constexpr int kStage = 32;                     // steps in the first group
constexpr int kAhead = 4;                      // steps of u ahead, in registers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}


// 2^x by the special function unit, a result below 2^-126 flushed to 0
// (exp2f adds three instructions to produce those as subnormals; they
// vanish in every sum here)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus in log2 units: for y = x log2 e, log2(1 + 2^y) = softplus(x)
// log2 e, written as max(y, 0) + log2(1 + z), z = 2^-|y| in (0, 1], with
// log2(1 + z) = z q(z) and q a degree-8 polynomial fitted to log2(1 + z) /
// z on [0, 1] in relative error (2.0e-7 in f32): one special-function exp
// and ten FMA-pipe ops, where expf and log1pf take about thirty.  Within
// 2.6e-7 of softplus(x) log2 e relative for x in [-20, 30] (the rounding of
// y moves z by up to |y| 6e-8 relative beyond that; such a dt is below
// 2e-9).
__device__ __forceinline__ float softplus_log2(float y) {
  const float z = ex2_ftz(-fabsf(y));
  float q = 7.549181580543518e-3f;
  q = fmaf(q, z, -4.256705939769745e-2f);
  q = fmaf(q, z, 1.128561943769455e-1f);
  q = fmaf(q, z, -1.9711896777153015e-1f);
  q = fmaf(q, z, 2.7564141154289246e-1f);
  q = fmaf(q, z, -3.5840848088264465e-1f);
  q = fmaf(q, z, 4.8069295287132263e-1f);
  q = fmaf(q, z, -7.213401794433594e-1f);
  q = fmaf(q, z, 1.4426950216293335f);
  return fmaf(z, q, fmaxf(y, 0.f));
}

// 16-byte global -> shared copy that bypasses registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(addr), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

// Steps from .. to - 1 of a chunk's rows of a (B, S, N) f32 tensor (src
// at the chunk's first step) into dst (steps x N floats, contiguous in
// both) by cp.async, 16 bytes a copy; the caller commits the group.
template <int N>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int from, int to) {
  constexpr int kPer = N / 4;                  // 16-byte pieces a step
  for (int i = from * kPer + threadIdx.x; i < to * kPer; i += kThreads) {
    cp_async16(dst + 4 * i, src + 4 * i);
  }
}

// u[b, t, d] for t = t0 .. t0 + kAhead - 1 (0 past `steps` or off the
// channels)
template <typename T>
__device__ __forceinline__ void load_u(float (&v)[kAhead], const T* ub,
                                       int t0, int steps, int di, bool live) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    v[j] = (live && t0 + j < steps)
               ? to_f32(ub[static_cast<size_t>(t0 + j) * di]) : 0.f;
  }
}

// Kernel 1: chunk c's end state from zero, s_c[n], and its sum of dt, for
// chunks 0 .. nc - 2 (all L steps long).  carry (B, nc, di, N), dsum (B,
// nc, di).
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 4) selective_scan_chunk_kernel(
    const T* __restrict__ u, const float* __restrict__ w_dt,
    const float* __restrict__ dt_bias, const float* __restrict__ A_log,
    const float* __restrict__ Bc, float* __restrict__ carry,
    float* __restrict__ dsum, int S, int di, int L) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);           // [L][N]
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y + 1;
  const int t0 = c * L;
  const bool live = d < di;
  // two cp.async groups: the first kStage steps are scanned while the
  // rest land
  const float* Bb = Bc + (static_cast<size_t>(b) * S + t0) * N;
  copy_rows<N>(sB, Bb, 0, kStage);
  cp_async_commit();
  copy_rows<N>(sB, Bb, kStage, L);
  cp_async_commit();
  // dt = s ln2 with s = softplus_log2(u w2 + b2), so the decay exp(dt A)
  // is exp2(s A) and the drive dt u = s (u ln2)
  float A[N], h[N];
  float w2 = 0.f, b2 = 0.f;
  if (live) {
    w2 = w_dt[d] * kLog2e;
    b2 = dt_bias[d] * kLog2e;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? -expf(A_log[static_cast<size_t>(d) * N + n]) : 0.f;
    h[n] = 0.f;
  }
  float ds = 0.f;                              // the chunk's sum of s
  const T* ub = u + (static_cast<size_t>(b) * S + t0) * di + d;
  float uc[kAhead];
  load_u(uc, ub, 0, L, di, live);
  cp_async_wait<1>();
  __syncthreads();
  for (int g = 0; g < L; g += kAhead) {
    if (g == kStage) {
      cp_async_wait<0>();
      __syncthreads();
    }
    float un[kAhead];
    load_u(un, ub, g + kAhead, L, di, live);   // in flight under this group
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const float sv = softplus_log2(fmaf(uc[j], w2, b2));
      const float dtu = sv * (uc[j] * kLn2);
      ds += sv;
      const float4* Bt = reinterpret_cast<const float4*>(sB + (g + j) * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = Bt[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          h[n] = fmaf(ex2_ftz(sv * A[n]), h[n], dtu * bv[e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) uc[j] = un[j];
  }
  if (live) {
    const size_t row = (static_cast<size_t>(b) * nc + c) * di + d;
#pragma unroll
    for (int n = 0; n < N; ++n) carry[row * N + n] = h[n];
    dsum[row] = ds;
  }
}

// Kernel 2: one thread per (b, d, n).  H = h0 (or 0); for each chunk c in
// order, carry[c] becomes H, the chunk's start state, and, below the last
// chunk, H = exp2(A dsum_c) H + s_c with s_c the value carry[c] held.
// Loads run kAhead chunks ahead of the chain of multiply-adds.
template <int N>
__global__ void __launch_bounds__(kThreads) selective_scan_carry_kernel(
    const float* __restrict__ A_log, const float* h0, float* carry,
    const float* __restrict__ dsum, int B, int di, int nc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * di * N) return;
  const int n = i % N, d = (i / N) % di, b = i / (N * di);
  const float A = -expf(A_log[static_cast<size_t>(d) * N + n]);
  float H = h0 != nullptr ? h0[i] : 0.f;
  const size_t cs = static_cast<size_t>(di) * N;   // between chunks
  float* cb = carry + static_cast<size_t>(b) * nc * cs +
              static_cast<size_t>(d) * N + n;
  const float* db = dsum + static_cast<size_t>(b) * nc * di + d;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float s[kAhead], a[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = c0 + j < nc - 1;
      s[j] = in ? cb[(c0 + j) * cs] : 0.f;
      a[j] = in ? db[static_cast<size_t>(c0 + j) * di] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < nc) {
        cb[(c0 + j) * cs] = H;
        H = fmaf(ex2_ftz(A * a[j]), H, s[j]);
      }
    }
  }
}

// Kernel 3: chunk c of every channel from its start state (h0 when there
// is one chunk, else carry[c] after kernel 2), with the readout; the last
// chunk writes h_last.  start_b / start_c: floats between batch rows and
// between chunks of the start states.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 4) selective_scan_kernel(
    const T* __restrict__ u, const float* __restrict__ w_dt,
    const float* __restrict__ dt_bias, const float* __restrict__ A_log,
    const float* __restrict__ D_skip, const float* __restrict__ Bc,
    const float* __restrict__ Cc, const float* start, size_t start_b,
    size_t start_c, float* __restrict__ y, float* h_last, int S, int di,
    int L) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);           // [L][N]
  float* sC = sB + L * N;                                // [L][N]
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * L, steps = min(L, S - t0);
  const bool live = d < di;
  const size_t row = (static_cast<size_t>(b) * S + t0) * N;
  // two cp.async groups of B and C: the first kStage steps are scanned
  // while the rest land
  const int first = min(steps, kStage);
  copy_rows<N>(sB, Bc + row, 0, first);
  copy_rows<N>(sC, Cc + row, 0, first);
  cp_async_commit();
  copy_rows<N>(sB, Bc + row, first, steps);
  copy_rows<N>(sC, Cc + row, first, steps);
  cp_async_commit();
  float A[N], h[N];
  float w2 = 0.f, b2 = 0.f, Dsk = 0.f;
  if (live) {
    w2 = w_dt[d] * kLog2e;
    b2 = dt_bias[d] * kLog2e;
    Dsk = D_skip[d];
  }
  const float* st = start == nullptr ? nullptr
                    : start + b * start_b + c * start_c +
                          static_cast<size_t>(d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? -expf(A_log[static_cast<size_t>(d) * N + n]) : 0.f;
    h[n] = (live && st != nullptr) ? st[n] : 0.f;
  }
  const T* ub = u + (static_cast<size_t>(b) * S + t0) * di + d;
  float* yb = y + (static_cast<size_t>(b) * S + t0) * di + d;
  float uc[kAhead];
  load_u(uc, ub, 0, steps, di, live);
  cp_async_wait<1>();
  __syncthreads();
  for (int g = 0; g < steps; g += kAhead) {
    if (g == kStage) {
      cp_async_wait<0>();
      __syncthreads();
    }
    float un[kAhead];
    load_u(un, ub, g + kAhead, steps, di, live);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (g + j < steps) {
        const float uv = uc[j];
        const float sv = softplus_log2(fmaf(uv, w2, b2));
        const float dtu = sv * (uv * kLn2);
        float yv = Dsk * uv;
        const float4* Bt = reinterpret_cast<const float4*>(sB + (g + j) * N);
        const float4* Ct = reinterpret_cast<const float4*>(sC + (g + j) * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 bq = Bt[q], cq = Ct[q];
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 4 * q + e;
            h[n] = fmaf(ex2_ftz(sv * A[n]), h[n], dtu * bv[e]);
            yv = fmaf(h[n], cv[e], yv);
          }
        }
        if (live) yb[static_cast<size_t>(g + j) * di] = yv;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) uc[j] = un[j];
  }
  if (live && c == gridDim.y - 1) {
    float* hl = h_last + (static_cast<size_t>(b) * di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hl[n] = h[n];
  }
}

template <int N, typename T>
int launch(cudaStream_t s, const void* u_, const float* w_dt,
           const float* dt_bias, const float* A_log, const float* D_skip,
           const float* Bc, const float* Cc, const float* h0, float* y,
           float* h_last, float* scratch, int B, int S, int di) {
  const T* u = static_cast<const T*>(u_);
  constexpr int L = kChunk;
  constexpr int chunk_smem = L * N * 4, scan_smem = 2 * chunk_smem;
  static_assert(scan_smem <= 48 * 1024, "no opt-in above 48 KB");
  const int nc = (S + L - 1) / L;
  const int blocks = (di + kThreads - 1) / kThreads;
  if (nc == 1) {
    selective_scan_kernel<N, T><<<dim3(blocks, 1, B), kThreads, scan_smem,
                                  s>>>(
        u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0,
        static_cast<size_t>(di) * N, 0, y, h_last, S, di, L);
    return static_cast<int>(cudaGetLastError());
  }
  float* carry = scratch;                              // (B, nc, di, N)
  float* dsum = scratch + static_cast<size_t>(B) * nc * di * N;  // (B, nc, di)
  selective_scan_chunk_kernel<N, T><<<dim3(blocks, nc - 1, B), kThreads,
                                      chunk_smem, s>>>(
      u, w_dt, dt_bias, A_log, Bc, carry, dsum, S, di, L);
  const int states = B * di * N;
  selective_scan_carry_kernel<N><<<(states + kThreads - 1) / kThreads,
                                   kThreads, 0, s>>>(A_log, h0, carry, dsum,
                                                     B, di, nc);
  selective_scan_kernel<N, T><<<dim3(blocks, nc, B), kThreads, scan_smem,
                                s>>>(
      u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, carry,
      static_cast<size_t>(nc) * di * N, static_cast<size_t>(di) * N, y,
      h_last, S, di, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 bf16, 1 f32 (u's).  h0 may be null (zeros); h_last may be h0.
// scratch: null when S <= kChunk, else B * ceil(S / kChunk) * di * (N + 1)
// floats (the chunks' states and dt sums), 16-byte aligned.  Bc and Cc
// 16-byte aligned.
extern "C" int selective_scan_fwd(const void* u, const void* w_dt,
                                  const void* dt_bias, const void* A_log,
                                  const void* D_skip, const void* Bc,
                                  const void* Cc, const void* h0, void* y,
                                  void* h_last, void* scratch, int B, int S,
                                  int di, int N, int dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || (N != 8 && N != 16) ||
      (dtype != 0 && dtype != 1) || (S + kChunk - 1) / kChunk > 65535 ||
      (S > kChunk && scratch == nullptr) ||
      static_cast<long long>(B) * di * N > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  float* sc = static_cast<float*>(scratch);
  if (N == 16) {
    return dtype == 0
               ? launch<16, __nv_bfloat16>(s, u, w, bias, al, ds, bc, cc, hi,
                                           yo, ho, sc, B, S, di)
               : launch<16, float>(s, u, w, bias, al, ds, bc, cc, hi, yo, ho,
                                   sc, B, S, di);
  }
  return dtype == 0
             ? launch<8, __nv_bfloat16>(s, u, w, bias, al, ds, bc, cc, hi, yo,
                                        ho, sc, B, S, di)
             : launch<8, float>(s, u, w, bias, al, ds, bc, cc, hi, yo, ho, sc,
                                B, S, di);
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

namespace {

constexpr int kSub = 8;                        // steps a sub-chunk
constexpr int kCkpts = (kChunk + kSub - 1) / kSub;

__device__ __forceinline__ void from_f32(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

// The same step for the four states a thread of kernel 3 holds (states
// 4 q .. 4 q + 3, bq = B_t's four values).
__device__ __forceinline__ void scan_step4(float (&h)[4], const float (&A)[4],
                                           float sv, float dtu, float4 bq) {
  const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = fmaf(ex2_ftz(sv * A[i]), h[i], dtu * bv[i]);
  }
}

// One level of a transposing butterfly: lanes apart by `o` exchange halves
// of their M values, each keeping one half and adding its partner's copy of
// it (the upper lane the upper half), so M values become M / 2 and three
// levels sum 8 values over 8 lanes with 7 shuffles; a fixed order.
template <int M, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = up ? v[i] : v[i + M / 2];
    const float keep = up ? v[i + M / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// Kernel 1: chunk c's adjoint from zero at its start, g = (g + C_t dy_t)
// a_t from its last step to its first, and its sum of s, for chunks 1 ..
// nc - 1 (the last may be short).  gl (B, nc, di, N), gs (B, nc, di).
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 4) selective_scan_bwd_chunk_kernel(
    const T* __restrict__ u, const float* __restrict__ w_dt,
    const float* __restrict__ dt_bias, const float* __restrict__ A_log,
    const float* __restrict__ Cc, const float* __restrict__ dy,
    float* __restrict__ gl, float* __restrict__ gs, int S, int di, int L) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y + 1, b = blockIdx.z, nc = gridDim.y + 1;
  const int t0 = c * L, steps = min(L, S - t0);
  if (d >= di) return;
  const float w2 = w_dt[d] * kLog2e, b2 = dt_bias[d] * kLog2e;
  float A[N], g[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = -expf(A_log[static_cast<size_t>(d) * N + n]);
    g[n] = 0.f;
  }
  const size_t row = static_cast<size_t>(b) * S + t0;
  const T* ub = u + row * di + d;
  const float* dyb = dy + row * di + d;
  const float4* Cb = reinterpret_cast<const float4*>(Cc + row * N);
  float ds = 0.f;
#pragma unroll 4
  for (int j = steps - 1; j >= 0; --j) {
    const float uv = to_f32(ub[static_cast<size_t>(j) * di]);
    const float dyv = dyb[static_cast<size_t>(j) * di];
    const float sv = softplus_log2(fmaf(uv, w2, b2));
    ds += sv;
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 cq = __ldg(Cb + j * (N / 4) + q);
      const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * q + e;
        g[n] = fmaf(cv[e], dyv, g[n]) * ex2_ftz(sv * A[n]);
      }
    }
  }
  const size_t o = (static_cast<size_t>(b) * nc + c) * di + d;
#pragma unroll
  for (int n = 0; n < N; ++n) gl[o * N + n] = g[n];
  gs[o] = ds;
}

// Kernel 2: one thread per (b, d, n).  G = dh_last (or 0); for each chunk
// c from the last, gl[c] becomes G, the adjoint entering the chunk at its
// end, and, above chunk 0, G = l_c + exp2(A sum_c s) G with l_c the value
// gl[c] held.  Loads run kAhead chunks ahead of the chain.
template <int N>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_carry_kernel(
    const float* __restrict__ A_log, const float* __restrict__ dh_last,
    float* gl, const float* __restrict__ gs, int B, int di, int nc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * di * N) return;
  const int n = i % N, d = (i / N) % di, b = i / (N * di);
  const float A = -expf(A_log[static_cast<size_t>(d) * N + n]);
  float G = dh_last != nullptr ? dh_last[i] : 0.f;
  const size_t cs = static_cast<size_t>(di) * N;
  float* gb = gl + static_cast<size_t>(b) * nc * cs +
              static_cast<size_t>(d) * N + n;
  const float* sb = gs + static_cast<size_t>(b) * nc * di + d;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float l[kAhead], a[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = c0 - j >= 1;
      l[j] = in ? gb[(c0 - j) * cs] : 0.f;
      a[j] = in ? sb[static_cast<size_t>(c0 - j) * di] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 - j >= 0) {
        gb[(c0 - j) * cs] = G;
        G = fmaf(ex2_ftz(A * a[j]), G, l[j]);
      }
    }
  }
}

// Kernel 3: chunk c of kThreads / (N / 4) channels, N / 4 threads a
// channel (thread q holds states 4 q .. 4 q + 3).  start: each chunk's
// start state (the forward's scratch, or h0 at one chunk; null: zeros);
// gin: the adjoint entering each chunk at its end (kernel 2's gl, or
// dh_last at one chunk; null: zeros), floats start_b / gin_b between batch
// rows and start_c / gin_c between chunks.  The states at every kSub-th
// step go to shared memory; a sub-chunk's h_{t-1}, s, u and dy stay in
// registers.  Writes du, the chunk's dA and its dw, db, dD partials
// (dA_part (B, nc, di, N), which may be gin itself: each thread reads its
// adjoint before it writes; p_part (3, B, nc, di)), the block's dB and dC
// partials (B, blocks, S, N) and, at chunk 0, dh0.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_kernel(
    const T* __restrict__ u, const float* __restrict__ w_dt,
    const float* __restrict__ dt_bias, const float* __restrict__ A_log,
    const float* __restrict__ D_skip, const float* __restrict__ Bc,
    const float* __restrict__ Cc, const float* __restrict__ dy,
    const float* __restrict__ start, size_t start_b, size_t start_c,
    const float* gin, size_t gin_b, size_t gin_c, T* __restrict__ du,
    float* dA_part, float* __restrict__ p_part, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dh0, int S, int di,
    int L) {
  constexpr int Q = N / 4;                     // threads a channel
  constexpr int kChan = kThreads / Q;          // channels a block
  extern __shared__ float4 smem4[];
  float4* ck = smem4;                          // [kCkpts][kThreads]
  float* red = reinterpret_cast<float*>(smem4 + kCkpts * kThreads);
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = tid % Q;
  const int d = blockIdx.x * kChan + tid / Q;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L, steps = min(L, S - t0);
  const bool live = d < di;
  float A[4], h[4], g[4], dA[4];
  float wn = 0.f, w2 = 0.f, b2 = 0.f, Dsk = 0.f;
  if (live) {
    wn = w_dt[d];
    w2 = wn * kLog2e;
    b2 = dt_bias[d] * kLog2e;
    Dsk = D_skip[d];
  }
  const size_t sn = static_cast<size_t>(d) * N + 4 * q;   // the states
  const float* st = start == nullptr ? nullptr
                                     : start + b * start_b + c * start_c + sn;
  const float* gi = gin == nullptr ? nullptr : gin + b * gin_b + c * gin_c + sn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    A[i] = live ? -expf(A_log[sn + i]) : 0.f;
    h[i] = (live && st != nullptr) ? st[i] : 0.f;
    g[i] = (live && gi != nullptr) ? gi[i] : 0.f;
    dA[i] = 0.f;
  }
  const size_t row = static_cast<size_t>(b) * S + t0;
  const T* ub = u + row * di + d;
  const float* dyb = dy + row * di + d;
  const float4* Bb = reinterpret_cast<const float4*>(Bc + row * N) + q;
  const float4* Cb = reinterpret_cast<const float4*>(Cc + row * N) + q;

  // the state at the start of every sub-chunk
#pragma unroll 4
  for (int j = 0; j < steps; ++j) {
    if (j % kSub == 0) {
      ck[(j / kSub) * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
    }
    const float uv = live ? to_f32(ub[static_cast<size_t>(j) * di]) : 0.f;
    const float sv = softplus_log2(fmaf(uv, w2, b2));
    scan_step4(h, A, sv, sv * (uv * kLn2), __ldg(Bb + j * Q));
  }

  float dw = 0.f, db = 0.f, dD = 0.f;
  for (int j0 = ((steps - 1) / kSub) * kSub; j0 >= 0; j0 -= kSub) {
    const int len = min(kSub, steps - j0);
    const float4 c4 = ck[(j0 / kSub) * kThreads + tid];
    h[0] = c4.x;
    h[1] = c4.y;
    h[2] = c4.z;
    h[3] = c4.w;
    // the sub-chunk again, each step's h_{t-1}, s, u and dy kept
    float hp[kSub][4], sr[kSub], ur[kSub], dyr[kSub];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      if (k < len) {
        const int j = j0 + k;
        ur[k] = live ? to_f32(ub[static_cast<size_t>(j) * di]) : 0.f;
        dyr[k] = live ? dyb[static_cast<size_t>(j) * di] : 0.f;
        sr[k] = softplus_log2(fmaf(ur[k], w2, b2));
#pragma unroll
        for (int i = 0; i < 4; ++i) hp[k][i] = h[i];
        scan_step4(h, A, sr[k], sr[k] * (ur[k] * kLn2), __ldg(Bb + j * Q));
      }
    }
    // ... and walked backward
#pragma unroll
    for (int k = kSub - 1; k >= 0; --k) {
      if (k < len) {
        const int j = j0 + k;
        const float sv = sr[k], uv = ur[k], dyv = dyr[k];
        const float dt = sv * kLn2, dtu = sv * (uv * kLn2);
        const float4 bq = __ldg(Bb + j * Q), cq = __ldg(Cb + j * Q);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        float v[8];                            // dB, then dC, of the states
        float ddt = 0.f, dus = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ex2_ftz(sv * A[i]);
          g[i] = fmaf(cv[i], dyv, g[i]);                   // g_t
          v[i] = g[i] * dtu;
          v[4 + i] = fmaf(a, hp[k][i], dtu * bv[i]) * dyv;  // h_t dy_t
          const float qv = g[i] * a * hp[k][i];
          ddt = fmaf(A[i], qv, ddt);
          dus = fmaf(g[i], bv[i], dus);
          dA[i] = fmaf(dt, qv, dA[i]);
          g[i] *= a;                                       // onto h_{t-1}
        }
        // the channel's sums over its Q threads (adjacent lanes)
        if constexpr (Q == 4) {
          const bool up = (lane & 2) != 0;
          float x = (up ? dus : ddt) +
                    __shfl_xor_sync(0xffffffffu, up ? ddt : dus, 2);
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          const float y = __shfl_xor_sync(0xffffffffu, x, 2);
          ddt = up ? y : x;
          dus = up ? x : y;
        } else {
          ddt += __shfl_xor_sync(0xffffffffu, ddt, 1);
          dus += __shfl_xor_sync(0xffffffffu, dus, 1);
        }
        // d(dt) through softplus: sigmoid(x) from z = e^-|x|, x = u w + b
        ddt = fmaf(uv, dus, ddt);
        const float y = fmaf(uv, w2, b2);
        const float z = ex2_ftz(-fabsf(y));
        const float dx = ddt * ((y >= 0.f ? 1.f : z) / (1.f + z));
        if (live && q == 0) {
          from_f32(du[(row + j) * di + d],
                   fmaf(Dsk, dyv, fmaf(dt, dus, dx * wn)));
        }
        dw = fmaf(dx, uv, dw);
        db += dx;
        dD = fmaf(dyv, uv, dD);
        // dB and dC over the warp's channels (lanes of the same q): lane l
        // keeps value ((l >> 4) & 1) * 4 + ((l >> 3) & 1) * 2 + ((l >> 2) &
        // 1) of v, for the states of q = l % Q
        halve<8>(v, lane, 16);
        halve<4>(v, lane, 8);
        halve<2>(v, lane, 4);
        if constexpr (Q == 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
        red[k * kThreads + tid] = v[0];
      }
    }
    // ... and over the block's warps, a step's values in warp order
    __syncthreads();
    for (int i = tid; i < len * 32; i += kThreads) {
      const int k = i / 32, l = i % 32;
      if (Q == 2 && (l & 2)) continue;         // the same sums twice
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        sum += red[k * kThreads + w * 32 + l];
      }
      const int idx = ((l >> 4) & 1) * 4 + ((l >> 3) & 1) * 2 + ((l >> 2) & 1);
      const size_t o = ((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * S +
                        t0 + j0 + k) * N + 4 * (l % Q) + (idx & 3);
      (idx < 4 ? dB_part : dC_part)[o] = sum;
    }
    __syncthreads();
  }
  if (live) {
    const size_t o = (static_cast<size_t>(b) * nc + c) * di + d;
#pragma unroll
    for (int i = 0; i < 4; ++i) dA_part[o * N + 4 * q + i] = dA[i];
    if (q == 0) {
      const size_t plane = static_cast<size_t>(gridDim.z) * nc * di;
      p_part[o] = dw;
      p_part[plane + o] = db;
      p_part[2 * plane + o] = dD;
    }
    if (c == 0 && dh0 != nullptr) {
      float* dh = dh0 + (static_cast<size_t>(b) * di + d) * N + 4 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i) dh[i] = g[i];
    }
  }
}

// Kernel 4: dBc and dCc (B, S, N), the blocks' partials summed in block
// order; one thread per (b, t, n).
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_sum_kernel(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part,
    float* __restrict__ dBc, float* __restrict__ dCc, int B, int S, int N,
    int blocks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t per = static_cast<size_t>(S) * N;
  if (i >= B * per) return;
  const size_t b = i / per, r = i % per;
  float sb = 0.f, sc = 0.f;
  for (int p = 0; p < blocks; ++p) {
    const size_t o = (b * blocks + p) * per + r;
    sb += dB_part[o];
    sc += dC_part[o];
  }
  dBc[i] = sb;
  dCc[i] = sc;
}

// Kernel 5: one thread per (d, n): dA_log = A sum over (b, chunk) of dA;
// the thread of n = 0 also sums dw_dt, ddt_bias and dD_skip.
template <int N>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_param_kernel(
    const float* __restrict__ A_log, const float* __restrict__ dA_part,
    const float* __restrict__ p_part, float* __restrict__ dw_dt,
    float* __restrict__ ddt_bias, float* __restrict__ dA_log,
    float* __restrict__ dD_skip, int B, int nc, int di) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= di * N) return;
  const int n = i % N, d = i / N;
  const int rows = B * nc;                     // (b, chunk) in order
  float s = 0.f;
  for (int r = 0; r < rows; ++r) {
    s += dA_part[(static_cast<size_t>(r) * di + d) * N + n];
  }
  dA_log[i] = s * -expf(A_log[i]);
  if (n == 0) {
    const size_t plane = static_cast<size_t>(rows) * di;
    float w = 0.f, bs = 0.f, ds = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t o = static_cast<size_t>(r) * di + d;
      w += p_part[o];
      bs += p_part[plane + o];
      ds += p_part[2 * plane + o];
    }
    dw_dt[d] = w;
    ddt_bias[d] = bs;
    dD_skip[d] = ds;
  }
}

template <int N, typename T>
int launch_bwd(cudaStream_t s, const void* u_, const float* w_dt,
               const float* dt_bias, const float* A_log, const float* D_skip,
               const float* Bc, const float* Cc, const float* h0,
               const float* fwd, const float* dy, const float* dh_last,
               void* du_, float* dBc, float* dCc, float* dh0, float* dw_dt,
               float* ddt_bias, float* dA_log, float* dD_skip, float* scratch,
               int B, int S, int di) {
  const T* u = static_cast<const T*>(u_);
  T* du = static_cast<T*>(du_);
  constexpr int L = kChunk;
  const int nc = (S + L - 1) / L;
  const int blocks = (di + kThreads - 1) / kThreads;
  constexpr int kChan = kThreads / (N / 4);      // kernel 3's channels a block
  const int warps = (di + kChan - 1) / kChan;
  const size_t cells = static_cast<size_t>(B) * nc * di;
  float* gl = scratch;                           // (B, nc, di, N)
  float* gs = gl + cells * N;                    // (B, nc, di)
  float* pp = gs + cells;                        // (3, B, nc, di)
  float* dBp = pp + 3 * cells;                   // (B, blocks, S, N)
  float* dCp = dBp + static_cast<size_t>(B) * warps * S * N;
  const float* start = h0;
  size_t start_b = static_cast<size_t>(di) * N, start_c = 0;
  const float* gin = dh_last;
  size_t gin_b = static_cast<size_t>(di) * N, gin_c = 0;
  if (nc > 1) {
    selective_scan_bwd_chunk_kernel<N, T><<<dim3(blocks, nc - 1, B), kThreads,
                                            0, s>>>(
        u, w_dt, dt_bias, A_log, Cc, dy, gl, gs, S, di, L);
    const int states = B * di * N;
    selective_scan_bwd_carry_kernel<N><<<(states + kThreads - 1) / kThreads,
                                         kThreads, 0, s>>>(
        A_log, dh_last, gl, gs, B, di, nc);
    start = fwd;
    start_b = gin_b = static_cast<size_t>(nc) * di * N;
    start_c = gin_c = static_cast<size_t>(di) * N;
    gin = gl;
  }
  constexpr int smem = kCkpts * kThreads * static_cast<int>(sizeof(float4)) +
                       kSub * kThreads * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  selective_scan_bwd_kernel<N, T><<<dim3(warps, nc, B), kThreads, smem,
                                    s>>>(
      u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, dy, start, start_b, start_c,
      gin, gin_b, gin_c, du, gl, pp, dBp, dCp, dh0, S, di, L);
  const size_t outs = static_cast<size_t>(B) * S * N;
  selective_scan_bwd_sum_kernel<<<static_cast<unsigned>(
                                      (outs + kThreads - 1) / kThreads),
                                  kThreads, 0, s>>>(dBp, dCp, dBc, dCc, B, S,
                                                    N, warps);
  if (dA_log != nullptr) {
    selective_scan_bwd_param_kernel<N><<<(di * N + kThreads - 1) / kThreads,
                                         kThreads, 0, s>>>(
        A_log, gl, pp, dw_dt, ddt_bias, dA_log, dD_skip, B, nc, di);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of selective_scan_fwd at the same inputs.  fwd_scratch: the
// forward's scratch after its launch (the chunks' start states; null when
// S <= kChunk); dy (B, S, di) f32; dh_last (B, di, N) f32 or null (zeros).
// Writes du (u's dtype), dBc and dCc (B, S, N), dh0 (B, di, N) when not
// null, and dw_dt (di), ddt_bias (di), dA_log (di, N), dD_skip (di) when
// dA_log is not null (all four, or none).  scratch: B * nc * di * (N + 4) +
// 2 * B * ceil(di N / 512) * S * N floats, nc = ceil(S / kChunk).  Bc and
// Cc 16-byte aligned.
extern "C" int selective_scan_bwd(
    const void* u, const void* w_dt, const void* dt_bias, const void* A_log,
    const void* D_skip, const void* Bc, const void* Cc, const void* h0,
    const void* fwd_scratch, const void* dy, const void* dh_last, void* du,
    void* dBc, void* dCc, void* dh0, void* dw_dt, void* ddt_bias,
    void* dA_log, void* dD_skip, void* scratch, int B, int S, int di, int N,
    int dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || (N != 8 && N != 16) ||
      (dtype != 0 && dtype != 1) || (S + kChunk - 1) / kChunk > 65535 ||
      (S > kChunk && fwd_scratch == nullptr) || scratch == nullptr ||
      (dA_log != nullptr &&
       (dw_dt == nullptr || ddt_bias == nullptr || dD_skip == nullptr)) ||
      static_cast<long long>(B) * di * N > 2147483647LL ||
      static_cast<long long>(di) * N > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w_dt);
  const float* bias = static_cast<const float*>(dt_bias);
  const float* al = static_cast<const float*>(A_log);
  const float* dsk = static_cast<const float*>(D_skip);
  const float* bc = static_cast<const float*>(Bc);
  const float* cc = static_cast<const float*>(Cc);
  const float* hi = static_cast<const float*>(h0);
  const float* fw = static_cast<const float*>(fwd_scratch);
  const float* dyo = static_cast<const float*>(dy);
  const float* dhl = static_cast<const float*>(dh_last);
  float* dbc = static_cast<float*>(dBc);
  float* dcc = static_cast<float*>(dCc);
  float* dh = static_cast<float*>(dh0);
  float* dw = static_cast<float*>(dw_dt);
  float* dbias = static_cast<float*>(ddt_bias);
  float* dal = static_cast<float*>(dA_log);
  float* dds = static_cast<float*>(dD_skip);
  float* sc = static_cast<float*>(scratch);
  if (N == 16) {
    return dtype == 0
               ? launch_bwd<16, __nv_bfloat16>(s, u, w, bias, al, dsk, bc, cc,
                                               hi, fw, dyo, dhl, du, dbc, dcc,
                                               dh, dw, dbias, dal, dds, sc, B,
                                               S, di)
               : launch_bwd<16, float>(s, u, w, bias, al, dsk, bc, cc, hi, fw,
                                       dyo, dhl, du, dbc, dcc, dh, dw, dbias,
                                       dal, dds, sc, B, S, di);
  }
  return dtype == 0
             ? launch_bwd<8, __nv_bfloat16>(s, u, w, bias, al, dsk, bc, cc, hi,
                                            fw, dyo, dhl, du, dbc, dcc, dh, dw,
                                            dbias, dal, dds, sc, B, S, di)
             : launch_bwd<8, float>(s, u, w, bias, al, dsk, bc, cc, hi, fw,
                                    dyo, dhl, du, dbc, dcc, dh, dw, dbias, dal,
                                    dds, sc, B, S, di);
}
