// Flash attention backward for Hopper, sm_90a: the gradient of
// csrc/flash_attention.cu's forward.
//
//   P[s, t]  = exp(scale * q[s] . k[t] - lse[s])   (0 where t > s, causal)
//   D[s]     = dout[s] . out[s]
//   dv[t]    = sum_s P[s, t] dout[s]
//   dS[s, t] = P[s, t] (dout[s] . v[t] - D[s])
//   dq[s]    = scale sum_t dS[s, t] k[t]
//   dk[t]    = scale sum_s dS[s, t] q[s]
//
// per query head h and its KV head kh = h / (H / KV); dk and dv sum over
// the G = H / KV query heads of their group.  q, out, dout, dq (B, S, H,
// hd); k, v, dk, dv (B, T, KV, hd); lse and the scratch D (B, H, S) f32,
// lse in natural-log units as the forward writes it.  One dtype, bf16 or
// f32, hd in {32, 64, 128}; any S and T (ragged tiles are masked); causal
// compares absolute positions, key t against query s, as the forward does.
//
// Replaces no TPU kernel: the reference has no Pallas backward.  At
// chunked_attn_threshold tokens or more it trains through the jnp
// chunked_attention (src/repro/models/attention.py:102), which XLA
// differentiates; this file is the port's counterpart of that autodiff.
// The plain version is kernels/flash_attention.py::flash_attention_bwd_plain.
//
// What bounds it on an H100: at S = T = 8192, H 32, hd 128, causal, the
// function is five products of S T hd H / 2 multiply-adds each (Q K^T to
// recompute P, P^T dO, dO V^T, dS K, dS^T Q): 1.37e12 flop, 1.39 ms of bf16
// tensor-core work against some 0.3 GB of inputs and outputs (0.1 ms).  It
// is bound by operations.  This first version is the simple one: mma.sync
// from shared memory, Q K^T and dO V^T computed once in each of the two
// gradient kernels (seven products where five are needed), P and dS as hi
// + lo pairs of bf16 (another product each); wgmma, TMA and a fused dQ are
// left for a redesign.
//
// Three kernels behind one C entry point, launched in order on one stream:
//   (a) flash_bwd_dot_kernel: D = rowsum(dout * out) in f32, one warp a row.
//   (b) dK, dV: one block per (batch, KV head, tile of 64 keys), the
//       accumulators in registers.  It loops over the G query heads of its
//       group and over the query tiles at or below the diagonal, so the
//       GQA sum is taken inside the block: no atomics, no second pass.
//   (c) dQ: one block per (batch, query head, tile of 64 query rows),
//       looping over the key tiles at or below the diagonal.
// Every output element is summed by one thread in a fixed order: the
// gradient is bitwise the same run to run.
//
// Routes (the caller's flash_bwd_route, from dtype and hd alone):
//   route 1, "mma_sync" -- bf16, hd 32, 64 and 128: 4 warps, 16 rows (keys
//     in (b), queries in (c)) a warp.  mma.sync m16n8k16, bf16 operands,
//     f32 accumulation; operands by ldmatrix from shared memory (the .trans
//     form where the product runs over the rows of a tile), tiles streamed
//     by cp.async, double-buffered, zero-filled past S and T.  P and dS stay
//     in f32 and enter the products that consume them as a hi + lo pair of
//     bf16 (hopper::split_bf16), two mma.sync on the same B fragment, as the
//     forward does for P V: about 16 bits of P and dS.  Registers: the two
//     64 x hd f32 accumulators of (b) are 2 hd per thread at hd 128, so (b)
//     steps over 32 queries at a time (a 16 x 32 score tile per warp) and
//     reloads its K and V fragments from shared memory at every step
//     instead of holding them.
//   route 2, "fma" -- f32, hd 32, 64 and 128: FMA (never TF32), 256 threads
//     as 16 x 16 over 64 x 64 score tiles, the tiles stored transposed in
//     shared memory, P and dS passed through shared memory to the products.
//
// The contract (bf16): each row of dq, dk and dv within 1e-2 of that row's
// largest |value| of the same function in f64 on the same inputs (q, k, v,
// out, lse, dout), a row's largest value floored at 1e-2 of the whole
// gradient's (the first query row under causal masking has an exact dq of
// 0: a softmax over one key).  The bf16 outputs' own rounding takes 2^-9 of
// it.  D comes from the bf16 out, as in every flash backward: against the
// exact gradient (f64 attention's own out) the first rows of dq, whose
// dP - D cancels, move by more than that, while each tensor stays within
// about 2e-3 in relative L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::split_bf16;

constexpr int kThreadsMma = 128;    // route 1: 4 warps
constexpr int kPad = 8;             // bf16 of padding per shared-memory row
constexpr int kKeysDkv = 64;        // (b): keys per block, 16 a warp
constexpr int kQDkv = 32;           // (b): query rows per step
constexpr int kRowsDq = 64;         // (c): query rows per block, 16 a warp
constexpr int kKeysDq = 64;         // (c): keys per step
constexpr int kThreadsF32 = 256;    // route 2: 16 x 16
constexpr int kTileF32 = 64;        // route 2: rows of every tile
constexpr int kDotRows = 8;         // (a): rows per block, one a warp

// d += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills the 16
// bytes when `valid` is false (then nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0));
}
// The same for one float.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 bf16 matrices from shared memory, one register each; lane L
// gives the row address of matrix L / 8, row L % 8.  `.trans` hands each
// thread the transposed pairs (the B operand of a row-major tile).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dout * out)
// ---------------------------------------------------------------------------

template <typename Tin>
__global__ void __launch_bounds__(32 * kDotRows)
flash_bwd_dot_kernel(const Tin* __restrict__ out, const Tin* __restrict__ dout,
                     float* __restrict__ dsum, int S, int H, int hd,
                     long long rows) {
  // row = (b S + s) H + h, warp-uniform
  const long long row = static_cast<long long>(blockIdx.x) * kDotRows +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const Tin* o = out + row * hd;
  const Tin* d = dout + row * hd;
  float acc = 0.0f;
  for (int i = lane; i < hd; i += 32) acc += to_f32(o[i]) * to_f32(d[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const long long h = row % H, s = (row / H) % S, b = row / (static_cast<
        long long>(H) * S);
    dsum[(b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// route 1, bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

// Fragments of this warp's 16 rows (`arow`) of a tile, one k16 step: the A
// operand.  Matrix i of ldmatrix.x4 is rows (i & 1) * 8 .., columns
// (i >> 1) * 8 .. of the 16 x 16 block.
__device__ __forceinline__ int a_row(int warp, int lane) {
  return warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
}

// acc (16 rows x 8 NT cols) += A (16 rows of `a_tile`) . B^T (8 NT rows of
// `b_tile`), the product over HD columns of both (both row-major, LD apart).
template <int HD, int NT, int LD>
__device__ __forceinline__ void rows_dot_rows(float acc[NT][4],
                                              const __nv_bfloat16* a_tile,
                                              const __nv_bfloat16* b_tile,
                                              int warp, int lane) {
  const int arow = a_row(warp, lane);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; kk += 2) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a_tile + arow * LD + kk * 16 + (lane >> 4) * 8);
    ldsm_x4(a1, a_tile + arow * LD + (kk + 1) * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // b0, b1 of steps kk and kk + 1 from rows nt * 8 .. + 7
      uint32_t bf[4];
      ldsm_x4(bf, b_tile + (nt * 8 + (lane & 7)) * LD + kk * 16 +
                      (lane >> 3) * 8);
      mma_bf16(acc[nt], a0, bf[0], bf[1]);
      mma_bf16(acc[nt], a1, bf[2], bf[3]);
    }
  }
}

// out (16 rows x HD) += X (16 x 16 NK, f32 accumulator fragments: x[nt]
// holds columns nt * 8 ..) . C (16 NK rows of `c_tile` x HD), X entering
// as a hi + lo pair of bf16; C's B fragments by ldmatrix.trans.
template <int HD, int NT, int LD>
__device__ __forceinline__ void frag_dot_tile(float out[HD / 8][4],
                                              const float x[NT][4],
                                              const __nv_bfloat16* c_tile,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t xh[4], xl[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], xh[0], xl[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], xh[1], xl[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], xh[2], xl[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], xh[3], xl[3]);
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, c_tile + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * LD + (d + (lane >> 4)) * 8);
      mma_bf16(out[d], xh, bf[0], bf[1]);
      mma_bf16(out[d], xl, bf[0], bf[1]);
      mma_bf16(out[d + 1], xh, bf[2], bf[3]);
      mma_bf16(out[d + 1], xl, bf[2], bf[3]);
    }
  }
}

// Rows r0 (acc[.][0..1]) and r0 + 8 (acc[.][2..3]) of a (16 x HD) f32
// accumulator, times `mul`, as bf16 into rows of `dst` (`stride` apart);
// rows at or past `n` are not stored.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t stride,
                                           const float acc[HD / 8][4], int r0,
                                           int n, float mul, int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (r >= n) continue;
    __nv_bfloat16* row = dst + r * stride;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8 + 2 * t) =
          __floats2bfloat162_rn(mul * acc[d][2 * rr], mul * acc[d][2 * rr + 1]);
    }
  }
}

template <int HD>
struct DkvSmem {
  static constexpr int LD = HD + kPad;            // bf16 per smem row
  static constexpr int kKV = kKeysDkv * LD;       // a K or V tile
  static constexpr int kQ = kQDkv * LD;           // a Q or dO tile
  // K, V; Q and dO in two stages; lse and D of both stages
  static constexpr int kBytes = (2 * kKV + 4 * kQ) * 2 + 4 * kQDkv * 4;
};

// (b) dK, dV: block (b * KV + kh, key tile); warp w owns keys k0 + 16 w ..
template <int HD>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S, int T,
                           int H, int KV, float scale, int causal) {
  using SM = DkvSmem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LD = SM::LD;
  constexpr int DT = HD / 8;          // n-tiles over hd
  constexpr int CH = HD / 8;          // 16-byte chunks per row
  constexpr int NT = kQDkv / 8;       // n-tiles over a step's queries
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* vs = ks + SM::kKV;
  auto qbuf = [&](int i) { return vs + SM::kKV + 2 * i * SM::kQ; };
  auto dobuf = [&](int i) { return vs + SM::kKV + (2 * i + 1) * SM::kQ; };
  float* lse_s = reinterpret_cast<float*>(vs + SM::kKV + 4 * SM::kQ);
  float* dsum_s = lse_s + 2 * kQDkv;  // [2][kQDkv] each

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * kKeysDkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = static_cast<size_t>(H) * HD;    // between tokens
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t kv_off = static_cast<size_t>(b) * T * kv_stride +
                        static_cast<size_t>(kh) * HD;

  for (int i = tid; i < kKeysDkv * CH; i += kThreadsMma) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = k0 + r < T;
    const size_t off = kv_off + (in ? (k0 + r) * kv_stride + c : 0);
    cp_async16(ks + r * LD + c, k + off, in);
    cp_async16(vs + r * LD + c, v + off, in);
  }
  cp_async_commit();

  // steps: (query head kh * G + it / per_head, query tile qt0 + it %
  // per_head); under causal masking the tiles before the block's first key
  // hold no query that sees it
  const int n_qt = (S + kQDkv - 1) / kQDkv;
  const int qt0 = causal ? min(k0 / kQDkv, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  auto load_q = [&](int it, int buf) {
    const int hh = kh * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * kQDkv;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(hh) * HD;
    __nv_bfloat16* qsb = qbuf(buf);
    __nv_bfloat16* dsb = dobuf(buf);
    for (int i = tid; i < kQDkv * CH; i += kThreadsMma) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = q0 + r < S;
      const size_t off = q_off + (in ? (q0 + r) * q_stride + c : 0);
      cp_async16(qsb + r * LD + c, q + off, in);
      cp_async16(dsb + r * LD + c, dout + off, in);
    }
    if (tid < kQDkv) {
      const bool in = q0 + tid < S;
      const size_t off = in ? (static_cast<size_t>(b) * H + hh) * S + q0 + tid
                            : 0;
      cp_async4(lse_s + buf * kQDkv + tid, lse + off, in);
      cp_async4(dsum_s + buf * kQDkv + tid, dsum + off, in);
    }
    cp_async_commit();
  };

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.0f;
  }
  const int key_lo = k0 + warp * 16 + g;     // acc rows g and g + 8
  if (n_it > 0) load_q(0, 0);
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, buf ^ 1);
      cp_async_wait<1>();               // K, V and step it have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % per_head) * kQDkv;
    const __nv_bfloat16* qsb = qbuf(buf);
    const __nv_bfloat16* dsb = dobuf(buf);
    const float* ls = lse_s + buf * kQDkv;
    const float* dd = dsum_s + buf * kQDkv;

    // S^T = K Q^T, then P^T in place: s[nt][e] is key key_lo (e < 2) or
    // key_lo + 8, query q0 + nt * 8 + 2 t + (e & 1)
    float s[NT][4];
    rows_dot_rows<HD, NT, LD>(s, ks, qsb, warp, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + (e & 2) * 4;
        const int qi = nt * 8 + 2 * t + (e & 1);
        const bool live = q0 + qi < S && key < T && !(causal && key > q0 + qi);
        s[nt][e] = live ? expf(s[nt][e] * scale - ls[qi]) : 0.0f;
      }
    }
    frag_dot_tile<HD, NT, LD>(dv_acc, s, dsb, lane);     // dV += P^T dO
    float dp[NT][4];
    rows_dot_rows<HD, NT, LD>(dp, vs, dsb, warp, lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= dp[nt][e] - dd[nt * 8 + 2 * t + (e & 1)];   // dS^T
      }
    }
    frag_dot_tile<HD, NT, LD>(dk_acc, s, qsb, lane);     // dK += dS^T Q
    __syncthreads();                    // buffer `buf` is free for it + 2
  }
  cp_async_wait<0>();

  const size_t row_off = static_cast<size_t>(b) * T * kv_stride +
                         static_cast<size_t>(kh) * HD;
  store_rows<HD>(dk + row_off, kv_stride, dk_acc, key_lo, T, scale, t);
  store_rows<HD>(dv + row_off, kv_stride, dv_acc, key_lo, T, 1.0f, t);
}

template <int HD>
struct DqSmem {
  static constexpr int LD = HD + kPad;
  static constexpr int kTile = kRowsDq * LD;
  static_assert(kRowsDq == kKeysDq, "one tile size for Q, dO, K and V");
  // Q, dO; K and V in two stages
  static constexpr int kBytes = 6 * kTile * 2;
};

// (c) dQ: block (b * H + h, query tile); warp w owns rows q0 + 16 w ..
template <int HD>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dq, int S, int T, int H,
                         int KV, float scale, int causal) {
  using SM = DqSmem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LD = SM::LD;
  constexpr int DT = HD / 8;
  constexpr int CH = HD / 8;
  constexpr int NT = kKeysDq / 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* dos = qs + SM::kTile;
  auto kbuf = [&](int i) { return qs + (2 + 2 * i) * SM::kTile; };
  auto vbuf = [&](int i) { return qs + (3 + 2 * i) * SM::kTile; };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsDq;   // most keys first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * T * kv_stride +
                        static_cast<size_t>(kh) * HD;

  for (int i = tid; i < kRowsDq * CH; i += kThreadsMma) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < S;
    const size_t off = q_off + (in ? (q0 + r) * q_stride + c : 0);
    cp_async16(qs + r * LD + c, q + off, in);
    cp_async16(dos + r * LD + c, dout + off, in);
  }
  cp_async_commit();
  auto load_kv = [&](int j0, int buf) {
    __nv_bfloat16* kb = kbuf(buf);
    __nv_bfloat16* vb = vbuf(buf);
    for (int i = tid; i < kKeysDq * CH; i += kThreadsMma) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = j0 + r < T;
      const size_t off = kv_off + (in ? (j0 + r) * kv_stride + c : 0);
      cp_async16(kb + r * LD + c, k + off, in);
      cp_async16(vb + r * LD + c, v + off, in);
    }
    cp_async_commit();
  };

  int n_tiles = (T + kKeysDq - 1) / kKeysDq;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRowsDq, S) - 1) / kKeysDq + 1);
  const int qpos0 = q0 + warp * 16 + g;      // rows g and g + 8
  float row_lse[2], row_d[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = qpos0 + 8 * rr;
    const size_t i = (static_cast<size_t>(b) * H + h) * S + qpos;
    row_lse[rr] = qpos < S ? lse[i] : 0.0f;
    row_d[rr] = qpos < S ? dsum[i] : 0.0f;
  }
  float dq_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dq_acc[d][0] = dq_acc[d][1] = dq_acc[d][2] = dq_acc[d][3] = 0.0f;
  }

  load_kv(0, 0);
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kKeysDq;
    if (jt + 1 < n_tiles) {
      load_kv(j0 + kKeysDq, (jt + 1) & 1);
      cp_async_wait<1>();               // Q, dO and tile jt have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kbuf(jt & 1);
    const __nv_bfloat16* vs = vbuf(jt & 1);

    // S = Q K^T, then P in place: s[nt][e] is query qpos0 (e < 2) or
    // qpos0 + 8, key j0 + nt * 8 + 2 t + (e & 1)
    float s[NT][4];
    rows_dot_rows<HD, NT, LD>(s, qs, ks, warp, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qpos0 + (e & 2) * 4;
        const int key = j0 + nt * 8 + 2 * t + (e & 1);
        const bool live = qpos < S && key < T && !(causal && key > qpos);
        s[nt][e] = live ? expf(s[nt][e] * scale - row_lse[e >> 1]) : 0.0f;
      }
    }
    float dp[NT][4];
    rows_dot_rows<HD, NT, LD>(dp, dos, vs, warp, lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - row_d[e >> 1];
    }
    frag_dot_tile<HD, NT, LD>(dq_acc, s, ks, lane);       // dQ += dS K
    __syncthreads();                    // buffer jt & 1 is free for jt + 2
  }

  store_rows<HD>(dq + q_off, q_stride, dq_acc, qpos0, S, scale, t);
}

// ---------------------------------------------------------------------------
// route 2, f32: FMA
// ---------------------------------------------------------------------------

template <int HD>
struct BwdF32Smem {
  static constexpr int LDT = kTileF32 + 1;    // tiles stored transposed
  static constexpr int LDP = kTileF32 + 16;   // P / dS rows: 16 banks apart
  static constexpr int kT = HD * LDT;
  // (b): K^T, V^T, Q^T, dO^T, P, dS; (c): Q^T, dO^T, K^T, V^T, dS
  static constexpr int kBytesDkv = (4 * kT + 2 * kTileF32 * LDP) * 4;
  static constexpr int kBytesDq = (4 * kT + kTileF32 * LDP) * 4;
};

// rows r0 .. r0 + 63 (zero past n) of a (.., hd) tensor whose rows are
// `stride` apart, into dst[c * LDT + r] (transposed)
template <int HD, int LDT>
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       size_t stride, int r0, int n) {
  for (int i = threadIdx.x; i < kTileF32 * HD; i += kThreadsF32) {
    const int r = i / HD, c = i % HD;
    dst[c * LDT + r] = r0 + r < n ? src[(r0 + r) * stride + c] : 0.0f;
  }
}

// acc[a][j] = sum_d x[d][ty + 16 a] y[d][tx + 16 j] over the transposed
// tiles x and y
template <int HD, int LDT>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* x,
                                         const float* y, int tx, int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = x[d * LDT + ty + 16 * a];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = y[d * LDT + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(xv[a], yv[j], acc[a][j]);
    }
  }
}

// (b) dK, dV: block (b * KV + kh, 64-key tile); thread (ty, tx) owns keys
// ty + 16 a and, of the 64 x 64 score tiles, queries tx + 16 j; of dK and
// dV, columns tx + 16 c
template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int T, int H, int KV, float scale,
                          int causal) {
  using SM = BwdF32Smem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LDT = SM::LDT, LDP = SM::LDP;
  constexpr int DC = HD / 16;
  float* kt = reinterpret_cast<float*>(bwd_smem);
  float* vt = kt + SM::kT;
  float* qt = vt + SM::kT;
  float* ot = qt + SM::kT;
  float* ps = ot + SM::kT;                    // [64][LDP]
  float* dss = ps + kTileF32 * LDP;           // [64][LDP]

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * kTileF32;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t kv_off = static_cast<size_t>(b) * T * kv_stride +
                        static_cast<size_t>(kh) * HD;
  load_t<HD, LDT>(kt, k + kv_off, kv_stride, k0, T);
  load_t<HD, LDT>(vt, v + kv_off, kv_stride, k0, T);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;
  }
  const int n_qt = (S + kTileF32 - 1) / kTileF32;
  const int qt0 = causal ? min(k0 / kTileF32, n_qt) : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int hh = kh * G + gi;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(hh) * HD;
    const size_t row_off = (static_cast<size_t>(b) * H + hh) * S;
    for (int qt_i = qt0; qt_i < n_qt; ++qt_i) {
      const int q0 = qt_i * kTileF32;
      __syncthreads();                  // the last step's tiles are read
      load_t<HD, LDT>(qt, q + q_off, q_stride, q0, S);
      load_t<HD, LDT>(ot, dout + q_off, q_stride, q0, S);
      float ls[4], dd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        ls[j] = qpos < S ? lse[row_off + qpos] : 0.0f;
        dd[j] = qpos < S ? dsum[row_off + qpos] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<HD, LDT>(s, kt, qt, tx, ty);     // S^T = K Q^T
      tile_dot<HD, LDT>(dp, vt, ot, tx, ty);    // dP^T = V dO^T
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int key = k0 + ty + 16 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool live = qpos < S && key < T && !(causal && key > qpos);
          const float p = live ? expf(s[a][j] * scale - ls[j]) : 0.0f;
          ps[(ty + 16 * a) * LDP + tx + 16 * j] = p;
          dss[(ty + 16 * a) * LDP + tx + 16 * j] = p * (dp[a][j] - dd[j]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q, over the tile's 64 queries
#pragma unroll 4
      for (int j = 0; j < kTileF32; ++j) {
        float pv[4], sv[4], ov[DC], qv[DC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = ps[(ty + 16 * a) * LDP + j];
          sv[a] = dss[(ty + 16 * a) * LDP + j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = ot[(tx + 16 * c) * LDT + j];
          qv[c] = qt[(tx + 16 * c) * LDT + j];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[a][c] = fmaf(pv[a], ov[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sv[a], qv[c], dk_acc[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t i = kv_off + key * kv_stride + tx + 16 * c;
      dk[i] = scale * dk_acc[a][c];
      dv[i] = dv_acc[a][c];
    }
  }
}

// (c) dQ: block (b * H + h, 64-row query tile); thread (ty, tx) owns rows
// ty + 16 a and, of each 64 x 64 score tile, keys tx + 16 j; of dQ,
// columns tx + 16 c
template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dq, int S, int T, int H, int KV,
                        float scale, int causal) {
  using SM = BwdF32Smem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LDT = SM::LDT, LDP = SM::LDP;
  constexpr int DC = HD / 16;
  float* qt = reinterpret_cast<float*>(bwd_smem);
  float* ot = qt + SM::kT;
  float* kt = ot + SM::kT;
  float* vt = kt + SM::kT;
  float* dss = vt + SM::kT;                   // [64][LDP]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileF32;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * T * kv_stride +
                        static_cast<size_t>(kh) * HD;
  load_t<HD, LDT>(qt, q + q_off, q_stride, q0, S);
  load_t<HD, LDT>(ot, dout + q_off, q_stride, q0, S);
  float ls[4], dd[4], dq_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qpos = q0 + ty + 16 * a;
    const size_t i = (static_cast<size_t>(b) * H + h) * S + qpos;
    ls[a] = qpos < S ? lse[i] : 0.0f;
    dd[a] = qpos < S ? dsum[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[a][c] = 0.0f;
  }

  int n_tiles = (T + kTileF32 - 1) / kTileF32;
  if (causal) {
    n_tiles = min(n_tiles, (min(q0 + kTileF32, S) - 1) / kTileF32 + 1);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTileF32;
    __syncthreads();                    // the last step's tiles are read
    load_t<HD, LDT>(kt, k + kv_off, kv_stride, j0, T);
    load_t<HD, LDT>(vt, v + kv_off, kv_stride, j0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD, LDT>(s, qt, kt, tx, ty);       // S = Q K^T
    tile_dot<HD, LDT>(dp, ot, vt, tx, ty);      // dP = dO V^T
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + tx + 16 * j;
        const bool live = qpos < S && key < T && !(causal && key > qpos);
        const float p = live ? expf(s[a][j] * scale - ls[a]) : 0.0f;
        dss[(ty + 16 * a) * LDP + tx + 16 * j] = p * (dp[a][j] - dd[a]);
      }
    }
    __syncthreads();
    // dQ += dS K, over the tile's 64 keys
#pragma unroll 4
    for (int j = 0; j < kTileF32; ++j) {
      float sv[4], kv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = dss[(ty + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = kt[(tx + 16 * c) * LDT + j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dq_acc[a][c] = fmaf(sv[a], kv[c], dq_acc[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qpos = q0 + ty + 16 * a;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dq[q_off + qpos * q_stride + tx + 16 * c] = scale * dq_acc[a][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *dq, *dk, *dv, *dsum;
  int B, S, T, H, KV, causal;
  float scale;
};

template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int e1 = set_smem(flash_bwd_dkdv_bf16_kernel<HD>, DkvSmem<HD>::kBytes);
  if (e1 != 0) return e1;
  flash_bwd_dkdv_bf16_kernel<HD>
      <<<dim3(a.B * a.KV, (a.T + kKeysDkv - 1) / kKeysDkv), kThreadsMma,
         DkvSmem<HD>::kBytes, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.S, a.T, a.H, a.KV,
          a.scale, a.causal);
  const int e2 = static_cast<int>(cudaGetLastError());
  if (e2 != 0) return e2;
  const int e3 = set_smem(flash_bwd_dq_bf16_kernel<HD>, DqSmem<HD>::kBytes);
  if (e3 != 0) return e3;
  flash_bwd_dq_bf16_kernel<HD>
      <<<dim3(a.B * a.H, (a.S + kRowsDq - 1) / kRowsDq), kThreadsMma,
         DqSmem<HD>::kBytes, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<bf*>(a.dq), a.S, a.T, a.H, a.KV, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  using SM = BwdF32Smem<HD>;
  const int e1 = set_smem(flash_bwd_dkdv_f32_kernel<HD>, SM::kBytesDkv);
  if (e1 != 0) return e1;
  flash_bwd_dkdv_f32_kernel<HD>
      <<<dim3(a.B * a.KV, (a.T + kTileF32 - 1) / kTileF32), kThreadsF32,
         SM::kBytesDkv, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S, a.T, a.H,
          a.KV, a.scale, a.causal);
  const int e2 = static_cast<int>(cudaGetLastError());
  if (e2 != 0) return e2;
  const int e3 = set_smem(flash_bwd_dq_f32_kernel<HD>, SM::kBytesDq);
  if (e3 != 0) return e3;
  flash_bwd_dq_f32_kernel<HD>
      <<<dim3(a.B * a.H, (a.S + kTileF32 - 1) / kTileF32), kThreadsF32,
         SM::kBytesDq, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<float*>(a.dq), a.S, a.T, a.H, a.KV, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_dot(const Args& a, int hd, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.S * a.H;
  const long long blocks = (rows + kDotRows - 1) / kDotRows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dot_kernel<Tin><<<static_cast<unsigned>(blocks), 32 * kDotRows, 0,
                              stream>>>(
      static_cast<const Tin*>(a.out), static_cast<const Tin*>(a.dout),
      static_cast<float*>(a.dsum), a.S, a.H, hd, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches (a), (b) and (c) on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success).  The caller checks devices, dtypes
// and contiguity, and that the pointers are 16-byte aligned; B, S, T, H >= 1
// and H % KV == 0.  lse (B, H, S) f32 from the forward; dsum is f32 scratch
// of the same shape that (a) fills.  dtype 0 = bf16, 1 = f32.  route 1 =
// mma_sync (bf16, hd 32, 64 or 128), 2 = fma (f32, hd 32, 64 or 128); a
// route that the dtype and hd do not select is refused.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* dsum, int B, int S, int T,
                                   int H, int KV, int hd, int dtype,
                                   int causal, float scale, int route,
                                   void* stream) {
  const bool hd_ok = hd == 32 || hd == 64 || hd == 128;
  const bool fits = hd_ok && ((route == 1 && dtype == 0) ||
                              (route == 2 && dtype == 1));
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      !fits || (S + 63) / 64 > 65535 || (T + 63) / 64 > 65535 ||
      static_cast<long long>(B) * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, out, lse, dout, dq, dk, dv, dsum,
               B, S, T, H, KV, causal, scale};
  const int e = dtype == 0 ? launch_dot<__nv_bfloat16>(a, hd, s)
                           : launch_dot<float>(a, hd, s);
  if (e != 0) return e;
  if (route == 1) {
    switch (hd) {
      case 32: return launch_bf16<32>(a, s);
      case 64: return launch_bf16<64>(a, s);
      default: return launch_bf16<128>(a, s);
    }
  }
  switch (hd) {
    case 32: return launch_f32<32>(a, s);
    case 64: return launch_f32<64>(a, s);
    default: return launch_f32<128>(a, s);
  }
}
