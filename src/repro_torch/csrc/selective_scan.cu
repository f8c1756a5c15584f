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
