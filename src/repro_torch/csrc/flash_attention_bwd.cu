// Flash attention backward for Hopper, sm_90a: the gradient of
// csrc/flash_attention.cu's forward.
//
//   P[s, t]  = exp(scale * q[s] . k[t] - lse[s])   (0 where t > s, causal,
//              and, under a causal window W, where t <= s - W)
//   D[s]     = dout[s] . out[s]
//   dv[t]    = sum_s P[s, t] dout[s]
//   dS[s, t] = P[s, t] (dout[s] . v[t] - D[s])
//   dq[s]    = scale sum_t dS[s, t] k[t]
//   dk[t]    = scale sum_s dS[s, t] q[s]
//
// per query head h and its KV head kh = h / (H / KV); dk and dv sum over
// the G = H / KV query heads of their group.  q, out, dout, dq (B, S, H,
// hd); k, v, dk, dv (B, T, KV, hd); lse (B, H, S) f32 in natural-log units
// as the forward writes it; an f32 scratch for D (see the entry point at
// the end of this file).  One dtype, bf16 or f32, hd in {32, 64, 128,
// 256}; any S and T (ragged tiles are masked); causal compares absolute
// positions, key t against query s, as the forward does.
//
// A sliding window W (the forward's: key t kept for query s iff s - W < t
// <= s) is taken on every route as the forward takes it: dK / dV blocks
// skip the query tiles past their last key's window, dQ blocks the key
// tiles wholly below their first row's window, and only the tiles that
// cross the window's lower edge (or the diagonal) are masked.  The lse is
// the windowed forward's, which may lie far below the score of a key
// outside a row's window: such a P is set to an exact 0 (and so its dS),
// never computed as exp of its score.  With a window, every key tile past
// the first W / 64 sees about the same number of query tiles, so route 0's
// heaviest-first order (tile 0 first) stays right: the light tiles, at the
// end of the sequence, are issued last.
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
// is bound by operations.  Gemma-7b's H 16 at hd 256 is the same work;
// under a window W the five products run over the kept pairs only (about
// S W at W << S).  The bf16 kernels keep P and dS in f32 and feed
// them to the products that consume them as hi + lo pairs of bf16, two
// products each, and recompute S (and dP) in both gradient kernels: route
// 0 does ten product-units of work for the bound's five (S^T, dP^T and dV,
// dK as pairs in (b'); S, dP and dQ as a pair in (c')), as route 3 does.
//
// Routes (the caller's flash_route, from dtype and hd alone):
//   route 0, "wgmma" -- bf16, hd 128 (Yi-9B's long-sequence training):
//     (a') writes each row's lse log2 e and D into a scratch padded to 128
//     rows (lse +inf, D 0 past S, so that padded rows weigh exactly 0), 64
//     rows of each in turn.  (b') and (c') are the forward's route 0 turned
//     around: one producer warpgroup of which one thread issues TMA loads
//     from 4-D tensor maps over the real (hd, heads, seq, batch) layouts
//     (zero-filled past S and T), a ring of three stages with a full and an
//     empty mbarrier each, two consumer warpgroups on wgmma, setmaxnreg
//     24 / 240.
//     (b') one block per (batch, KV head, 64 keys), K and V loaded once;
//     64-row tiles of Q and dO with their 64 lse and D (one bulk copy)
//     stream through the ring for each of the G query heads in turn, so the
//     GQA sum is taken in the block.  Consumer 0 computes S^T = K Q^T
//     (m64n64k16, both K-major) and P^T = exp2(S^T scale log2 e - lse log2
//     e) (masked on the diagonal tile only), hands P^T to consumer 1
//     through a two-slot ring of its own (each thread's 32 values in
//     register order: both consumers hold the same (key, query) positions)
//     and accumulates dV += P^T dO; consumer 1 computes dP^T = V dO^T, dS^T
//     = P^T (dP^T - D) and dK += dS^T Q.  Each last product takes its A from
//     registers as hi + lo pairs (m64n128k16, dO or Q read MN-major through
//     the transpose bit).  One warpgroup holding dK and dV for its keys
//     (2 x 64 accumulator registers a thread beside the score tiles) was
//     spilled and serialised by ptxas (C7512) at 64- and at 32-query steps.
//     dK / dV a launch at 8192 tokens on an H100, by scripts/flash_bwd_ab.py
//     (PERF.md, section 6): both consumers computing S^T, 2.8 ms; consumer 1 handing P^T to
//     consumer 0 (a longer chain for one of them), 3.0 ms; issuing the next
//     step's first product ahead of the last one, serialised by ptxas
//     (C7515), 3.4 ms; this design 2.6 ms.  Key tiles are issued heaviest
//     first (tile 0 has the most query tiles under causal masking): at 8192
//     tokens 512 blocks on 132 SMs, one an SM.
//     (c') one block per (batch, query head, 128 rows), Q and dO loaded once;
//     64-key tiles of K and V stream through the ring.  Each consumer owns
//     64 rows: S = Q K^T and dP = dO V^T (m64n64k16), P, dS = P (dP - D),
//     dQ += dS K (m64n128k16, dS as hi + lo pairs, K MN-major).  Query
//     tiles last-first, the blocks with the most keys first; a 64-key tile
//     wholly after a consumer's rows (causal) is only handed back.
//   route 1, "mma_sync" -- bf16, hd 32 and 64 (the first version): 4 warps,
//     16 rows (keys in (b), queries in (c)) a warp.  mma.sync m16n8k16, bf16
//     operands, f32 accumulation; operands by ldmatrix from shared memory
//     (the .trans form where the product runs over the rows of a tile),
//     tiles streamed by cp.async, double-buffered, zero-filled past S and T.
//     P and dS stay in f32 and enter the products that consume them as a hi
//     + lo pair of bf16 (hopper::split_bf16), two mma.sync on the same B
//     fragment, as the forward does for P V: about 16 bits of P and dS.
//     (b) steps over 32 queries at a time (a 16 x 32 score tile per warp)
//     and reloads its K and V fragments from shared memory at every step.
//   route 2, "fma" -- f32, hd 32, 64, 128 and 256: FMA (never TF32), 256
//     threads as 16 x 16 over 64 x 64 score tiles, the tiles stored
//     transposed in shared memory, P and dS passed through shared memory to
//     the products.  S and dP are summed in f64 and rounded once, as is D
//     (a), so that dP - D cancels to within an ulp (tile_dot).  At hd 256
//     four transposed 64-row tiles would take 266 KB, so the key tiles are
//     32 rows ((b) blocks of 32 keys, (c) steps of 32 keys): 221 KB of
//     shared memory.
//   route 3, "hd256" -- bf16, hd 256 (gemma-7b): route 0's design at hd
//     256.  (a') at hd 256 into the same scratch.  A 64 x 256 f32
//     accumulator is 128 registers a thread, and a producer warpgroup's
//     warps would cap every thread at 168 (setmaxnreg never raised the
//     hd-256 forward's consumers past it), so each kernel runs two
//     consumer warpgroups alone, 256 threads that may take 255 registers,
//     one thread of them issuing the TMA loads (64 hd, 128 bytes, swizzled,
//     a box: four boxes a 256-wide row), as the hd-256 forward does.
//     (b'') one block per (batch, KV head, 64 keys): K and V loaded once
//     (64 KB), 64-row Q and dO tiles with their lse and D rows through a
//     two-stage ring (128 KB), P^T through two 16 KB slots: 231,496 B.
//     Warpgroup 0 computes S^T = K Q^T (m64n64k16, 16 k16 steps), P^T,
//     hands P^T to warpgroup 1 in register order and adds dV += P^T dO
//     (m64n256k16, P^T hi + lo from registers, dO MN-major); warpgroup 1
//     computes dP^T = V dO^T and dS^T and adds dK += dS^T Q.  Thread 0 of
//     dK's warpgroup, the one that runs behind, issues the loads.  Key
//     tiles heaviest first.  dK / dV a launch at gemma-7b's 8192 tokens on
//     an H100, by scripts/flash_bwd_ab.py (PERF.md, section 6):
//     the loads issued from dV's warpgroup, 2.9 ms; the next step's first
//     product queued behind the last, serialised by ptxas (C7515), 2.7 ms;
//     this design 2.3-2.4 ms.
//     (c'') one block per (batch, query head, 128 rows), each warpgroup
//     owning 64: Q and dO loaded once (128 KB); 64-key K and V stages (64
//     KB each) would fit beside them only once, so 32-key tiles stream
//     through a three-stage ring (96 KB): 230,456 B.  S = Q K^T and dP =
//     dO V^T are m64n32k16 (16 registers each), dQ += dS K m64n256k16 over
//     two k16 steps (dS hi + lo, K MN-major).  Query tiles last-first.  dQ
//     a launch, the same way: 64-key tiles with K and V loaded apart into
//     a three-slot ring, 1.97 ms; the next tile's S and dP queued behind
//     dQ, serialised (C7518), 2.27 ms; this design 1.90-2.00 ms.
// Routes 1 and 2 launch (a) D = rowsum(dout * out), one warp a row (any
// hd: a lane sums hd / 32 products), then (b) dK, dV per (batch, KV head,
// key tile), looping over the G query heads and the query tiles at or
// below the diagonal, then (c) dQ per (batch, query head, 64 rows).  Every
// output element of every route is summed by one thread in a fixed order:
// the gradient is bitwise the same run to run.
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
#include <type_traits>

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

// How far below its query a key may lie and still be seen, as in the
// forward: under a causal window W a key is masked where key + span <=
// query; without one the span is 2^30, which no position reaches.
constexpr int kNoSpan = 1 << 30;
__device__ __forceinline__ int window_span(int causal, int window) {
  return causal && window > 0 ? window : kNoSpan;
}

// dK / dV: one past the last query tile (of `rows` rows, n_qt in all) that
// sees any of the keys k0 .. k0 + nk - 1; under a window W the last such
// query is k0 + nk - 1 + W - 1.
__device__ __forceinline__ int query_tile_end(int k0, int nk, int span,
                                              int n_qt, int rows) {
  return span == kNoSpan ? n_qt : min(n_qt, (k0 + nk - 2 + span) / rows + 1);
}

// dQ: the first key tile (of `keys` keys) that a query tile starting at q0
// sees: under a window W the key q0 - W + 1, else key 0.
__device__ __forceinline__ int first_key_tile(int q0, int span, int keys) {
  return span == kNoSpan ? 0 : max(0, q0 - span + 1) / keys;
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
  // f32 inputs (route 2) sum in f64, as its dP does (tile_dot); bf16 in f32
  using Acc = typename std::conditional<std::is_same<Tin, float>::value,
                                        double, float>::type;
  Acc acc = 0;
  for (int i = lane; i < hd; i += 32) {
    acc += static_cast<Acc>(to_f32(o[i])) * static_cast<Acc>(to_f32(d[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const long long h = row % H, s = (row / H) % S, b = row / (static_cast<
        long long>(H) * S);
    dsum[(b * H + h) * S + s] = static_cast<float>(acc);
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
template <int HD, bool WIN>
__device__ __forceinline__ void
dkdv_bf16(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
          int S, int T, int H, int KV, float scale, int causal, int window) {
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
  // hold no query that sees it, and under a window those past its last
  // key's window neither
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  const int n_qt = (S + kQDkv - 1) / kQDkv;
  const int qt0 = causal ? min(k0 / kQDkv, n_qt) : 0;
  const int per_head =
      max(query_tile_end(k0, kKeysDkv, span, n_qt, kQDkv) - qt0, 0);
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
        const bool live = q0 + qi < S && key < T &&
                          !(causal && key > q0 + qi) &&
                          (!WIN || key + span > q0 + qi);
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
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S, int T, int H,
                           int KV, float scale, int causal, int window) {
  dkdv_bf16<HD, false>(q, k, v, dout, lse, dsum, dk, dv, S, T, H, KV, scale,
                       causal, window);
}

// the same under a causal window
template <int HD>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dkdv_bf16_window_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ dsum,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int S, int T,
                                  int H, int KV, float scale, int causal,
                                  int window) {
  dkdv_bf16<HD, true>(q, k, v, dout, lse, dsum, dk, dv, S, T, H, KV, scale,
                      causal, window);
}

template <int HD>
struct DqSmem {
  static constexpr int LD = HD + kPad;
  static constexpr int kQTile = kRowsDq * LD;
  static constexpr int kKVTile = kKeysDq * LD;
  // Q, dO; K and V in two stages
  static constexpr int kBytes = (2 * kQTile + 4 * kKVTile) * 2;
};

// (c) dQ: block (b * H + h, query tile); warp w owns rows q0 + 16 w ..
template <int HD, bool WIN>
__device__ __forceinline__ void
dq_bf16(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int S,
        int T, int H, int KV, float scale, int causal, int window) {
  using SM = DqSmem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LD = SM::LD;
  constexpr int DT = HD / 8;
  constexpr int CH = HD / 8;
  constexpr int KEYS = kKeysDq;
  constexpr int NT = KEYS / 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* dos = qs + SM::kQTile;
  auto kbuf = [&](int i) {
    return qs + 2 * SM::kQTile + 2 * i * SM::kKVTile;
  };
  auto vbuf = [&](int i) {
    return qs + 2 * SM::kQTile + (2 * i + 1) * SM::kKVTile;
  };

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
    for (int i = tid; i < KEYS * CH; i += kThreadsMma) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = j0 + r < T;
      const size_t off = kv_off + (in ? (j0 + r) * kv_stride + c : 0);
      cp_async16(kb + r * LD + c, k + off, in);
      cp_async16(vb + r * LD + c, v + off, in);
    }
    cp_async_commit();
  };

  // key tiles lo .. n_tiles - 1: under causal masking none past the block's
  // last row, under a window none wholly below its first row's window
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  int n_tiles = (T + KEYS - 1) / KEYS;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRowsDq, S) - 1) / KEYS + 1);
  const int lo = first_key_tile(q0, span, KEYS);
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

  load_kv(lo * KEYS, 0);
  for (int jt = lo; jt < n_tiles; ++jt) {
    const int j0 = jt * KEYS;
    const int buf = (jt - lo) & 1;
    if (jt + 1 < n_tiles) {
      load_kv(j0 + KEYS, buf ^ 1);
      cp_async_wait<1>();               // Q, dO and tile jt have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kbuf(buf);
    const __nv_bfloat16* vs = vbuf(buf);

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
        const bool live = qpos < S && key < T && !(causal && key > qpos) &&
                          (!WIN || key + span > qpos);
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

template <int HD>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dq, int S, int T, int H,
                         int KV, float scale, int causal, int window) {
  dq_bf16<HD, false>(q, k, v, dout, lse, dsum, dq, S, T, H, KV, scale, causal,
                     window);
}

// the same under a causal window
template <int HD>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dq_bf16_window_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                __nv_bfloat16* __restrict__ dq, int S, int T,
                                int H, int KV, float scale, int causal,
                                int window) {
  dq_bf16<HD, true>(q, k, v, dout, lse, dsum, dq, S, T, H, KV, scale, causal,
                    window);
}

// ---------------------------------------------------------------------------
// route 0, bf16, hd 128: TMA, an mbarrier ring, wgmma, a producer warpgroup
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;        // consumers: warpgroups 0, 1; producer: 2
constexpr int kWgProducerRegs = 24;    // setmaxnreg, per thread
constexpr int kWgConsumerRegs = 240;   // (24 + 2 x 240) x 128 = 168 x 384
constexpr int kWgStages = 3;           // the ring of streamed tiles
constexpr int kRowTile = 64;           // (b') keys a block, rows a step; (c') keys a step
constexpr int kWgBlock = 128;          // query rows of a (c') block
constexpr int kBox64 = 64 * 128;       // a TMA box of 64 rows x 64 bf16
constexpr int kBox128 = 128 * 128;     // a TMA box of 128 rows x 64 bf16
// per 64 query rows of the scratch: lse in log2 units, then D (f32 each)
constexpr int kRowsF32 = 2 * kRowTile;
constexpr float kLog2e = 1.4426950408889634f;

// (b'): K and V (64 keys), then per stage Q, dO (64 rows), then the P^T
// ring (128 threads x 32 f32 a slot), then the stages' lse and D rows;
// barriers after; 1 KB of slack to align the base
constexpr int kDkvStage = 4 * kBox64;
constexpr int kPSlots = 2;              // P^T handed from dV's warpgroup to dK's
constexpr int kPSlot = 128 * 32 * 4;
constexpr int kDkvBars = 1 + 2 * kWgStages + 2 * kPSlots;
constexpr int kDkvSmem = 1024 + 4 * kBox64 + kWgStages * kDkvStage +
                         kPSlots * kPSlot + kWgStages * kRowsF32 * 4 +
                         8 * kDkvBars;
// (c'): Q and dO (128 rows), then per stage K and V (64 keys)
constexpr int kDqStage = 4 * kBox64;
constexpr int kDqBars = 1 + 2 * kWgStages;
constexpr int kDqSmem = 1024 + 4 * kBox128 + kWgStages * kDqStage +
                        8 * kDqBars;

// 2^x by the special-function unit, a result below 2^-126 flushed to 0 (as
// in the forward's route 0)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Where row s of (b, h) = bh lies in route 0's scratch: the rows in chunks
// of 64, each chunk's 64 lse values followed by its 64 D values.
template <typename F>
__device__ __forceinline__ F* scratch_rows(F* rows, int bh, int S_pad, int s) {
  return rows + (static_cast<size_t>(bh) * (S_pad / kRowTile) + s / kRowTile) *
                    kRowsF32 + s % kRowTile;
}

// A 64 x N f32 accumulator (the M = N / 2 values a thread holds) as the A
// operands of N / 16 k16 steps, hi + lo pairs of bf16: step kk takes
// elements 8 kk .. 8 kk + 7 (chunks 2 kk and 2 kk + 1).
template <int M>
__device__ __forceinline__ void make_pairs(const float (&x)[M],
                                           uint32_t (&hi)[M / 8][4],
                                           uint32_t (&lo)[M / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < M / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e],
                 lo[kk][e]);
    }
  }
}

// (a') For every (b, h) and row s < S_pad: lse * log2 e and D = rowsum(dout
// * out) in f32 into the scratch, 64 rows of lse then their 64 D; rows
// past S get lse = +inf and D = 0.  One warp a row, rows in (b, s, h) order
// so that a warp's neighbours read the next HD * 2 bytes; a lane reads HD /
// 32 values of each (8 or 16 bytes) and sums their products in order
// before the warp's shuffles (at hd 128 the expression of the first
// version, so its bits).
template <int HD>
__global__ void __launch_bounds__(32 * kDotRows)
flash_bwd_rows_kernel(const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ rows,
                      int S, int S_pad, int H, long long n_rows) {
  constexpr int kPairs = HD / 64;              // bf16 pairs a lane
  using Vec = typename std::conditional<kPairs == 2, uint2, uint4>::type;
  static_assert(sizeof(Vec) == 4 * kPairs, "a lane's HD / 32 values");
  const long long row = static_cast<long long>(blockIdx.x) * kDotRows +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int h = static_cast<int>(row % H);
  const int s = static_cast<int>((row / H) % S_pad);
  const long long b = row / (static_cast<long long>(H) * S_pad);
  float acc = 0.0f;
  if (s < S) {
    const size_t off = ((b * S + s) * H + h) * HD + 2 * kPairs * lane;
    const Vec o = *reinterpret_cast<const Vec*>(out + off);
    const Vec d = *reinterpret_cast<const Vec*>(dout + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
    float2 of = __bfloat1622float2(o2[0]), df = __bfloat1622float2(d2[0]);
    acc = of.x * df.x + of.y * df.y;
#pragma unroll
    for (int i = 1; i < kPairs; ++i) {
      of = __bfloat1622float2(o2[i]);
      df = __bfloat1622float2(d2[i]);
      acc = acc + of.x * df.x + of.y * df.y;
    }
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off2);
    }
  }
  if (lane == 0) {
    const int bh = static_cast<int>(b * H + h);
    float* r = scratch_rows(rows, bh, S_pad, s);
    r[0] = s < S ? lse[static_cast<size_t>(bh) * S + s] * kLog2e : INFINITY;
    r[kRowTile] = acc;
  }
}

// (b')'s shared memory, as the consumers address it: K and V (64 keys),
// stage s's Q at q0_addr + s kDkvStage and dO 2 kBox64 after it, the P^T
// ring, the stages' lse and D rows, the barriers ((b'') at hd 256: stages
// kH2DkvStage apart, dO kH2Tile after Q).
struct DkvTiles {
  uint32_t k_addr, v_addr, q0_addr;
  float4* p0;
  const float* rows_s;
  uint64_t *kv_full, *full, *empty, *p_full, *p_empty;
};

// (b')'s consumer warpgroups, keys k0 .. k0 + 63, one code path a role so
// that ptxas sees each role's wgmma pipeline whole.  dV's (GRAD_K false):
// S^T = K Q^T (m64n64k16, both K-major), P^T = exp2(S^T scale log2 e -
// lse log2 e) (masked on the diagonal tile only), handed to dK's
// warpgroup through the P^T ring, then dV += P^T dO.  dK's: dP^T = V dO^T,
// dS^T = P^T (dP^T - D) with P^T from the ring, then dK += dS^T Q.  Both
// warpgroups hold the same (key, query) positions in their accumulators,
// so each thread hands its 32 values to the same thread of the other in
// register order.  A of the last product from registers as hi + lo pairs
// of bf16 (queries 16 kk .. + 15 are accumulator chunks 2 kk and 2 kk +
// 1), B = dO or Q read MN-major through the transpose bit.  Three
// product-units a step each, six in all.
template <bool GRAD_K, bool WIN>
__device__ __forceinline__ void dkdv_consumer(
    const DkvTiles& tl, int k0, int qt0, int per_head, int n_it, int T, int KV,
    int b, int kh, float scale_log2, int causal, int span,
    __nv_bfloat16* out, float mul) {
  using namespace hopper;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;            // accumulator rows g, g + 8
  const int me = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (n_it > 0) mbar_wait(tl.kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kWgStages, slot = it % kPSlots;
    const int q0 = (qt0 + it % per_head) * kRowTile;
    mbar_wait(&tl.full[s], (it / kWgStages) & 1);
    const uint32_t q_addr = tl.q0_addr + s * kDkvStage;
    const uint32_t do_addr = q_addr + 2 * kBox64;
    const float* rs_ = tl.rows_s + s * kRowsF32;
    float4* ring = tl.p0 + slot * (kPSlot / 16);
    // x[4 j + e] is key key_lo (e < 2) or key_lo + 8, query q0 + 8 j + 2 t +
    // (e & 1): S^T, then P^T (dV's) or dP^T, then dS^T (dK's)
    float x[32];
    const uint32_t a_addr = GRAD_K ? tl.v_addr : tl.k_addr;
    const uint32_t b_addr = GRAD_K ? do_addr : q_addr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n64k16_ss(
          x, desc_sw128(a_addr + (kk / 4) * kBox64 + (kk % 4) * 32, 16, 1024),
          desc_sw128(b_addr + (kk / 4) * kBox64 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if constexpr (!GRAD_K) {
      // rows past S carry lse = +inf (P = 0), keys past T are never
      // stored; masked on the diagonal tile and, under a window, on a tile
      // whose last rows lie past its first keys' window.  A masked P is an
      // exact 0: the windowed forward's lse may lie far below such a
      // score, whose exp2 would not be small.
      const bool diag = causal && k0 + 63 > q0;
      const bool wedge = WIN && q0 + 63 >= k0 + span;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rs_ + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = ex2_ftz(fmaf(x[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (diag || wedge) {
            const int key = key_lo + (e & 2) * 4;
            const int row = q0 + 8 * j + 2 * t + (e & 1);
            if ((diag && key > row) || (WIN && key + span <= row)) {
              p = 0.0f;
            }
          }
          x[i] = p;
        }
      }
      mbar_wait(&tl.p_empty[slot], ((it / kPSlots) & 1) ^ 1);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        ring[c * 128 + me] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2],
                                         x[4 * c + 3]);
      }
      mbar_arrive(&tl.p_full[slot]);
    } else {
      mbar_wait(&tl.p_full[slot], (it / kPSlots) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = ring[j * 128 + me];
        const float2 d2 =
            *reinterpret_cast<const float2*>(rs_ + kRowTile + 8 * j + 2 * t);
        x[4 * j] = p.x * (x[4 * j] - d2.x);
        x[4 * j + 1] = p.y * (x[4 * j + 1] - d2.y);
        x[4 * j + 2] = p.z * (x[4 * j + 2] - d2.x);
        x[4 * j + 3] = p.w * (x[4 * j + 3] - d2.y);
      }
      mbar_arrive(&tl.p_empty[slot]);
    }
    uint32_t ah[4][4], al[4][4];
    make_pairs(x, ah, al);
    const uint32_t c_addr = GRAD_K ? q_addr : do_addr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc_sw128(c_addr + kk * 2048, kBox64, 1024);
      wgmma_m64n128k16_rs(acc, ah[kk], d, 1);
      wgmma_m64n128k16_rs(acc, al[kk], d, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&tl.empty[s]);
  }
  fence_regs(acc);

  const size_t kv_stride = static_cast<size_t>(KV) * 128;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key_lo + 8 * rr;
    if (key >= T) continue;
    __nv_bfloat16* row = out + (static_cast<size_t>(b) * T + key) * kv_stride +
                         static_cast<size_t>(kh) * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(mul * acc[i], mul * acc[i + 1]);
    }
  }
}

// (b') dK, dV: block (b * KV + kh, tile of 64 keys).  Consumer warpgroup
// 0 accumulates dV, warpgroup 1 dK (dkdv_consumer): each holds one 64 x
// 128 f32 accumulator beside one 64 x 64 score tile.  One warpgroup
// holding both accumulators (2 x 64 registers a thread) left ptxas too
// few: it spilled and serialised the wgmma (C7512) at score tiles of 64
// and of 32 queries, whatever setmaxnreg asked for.  Key tiles in
// blockIdx.y order: under causal masking tile 0 has the most query tiles,
// so the heaviest blocks are issued first.
template <bool WIN>
__device__ __forceinline__ void
dkdv_wgmma(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
           const CUtensorMap& tm_k, const CUtensorMap& tm_v,
           const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int S, int S_pad, int T, int H,
           int KV, float scale, float scale_log2, int causal, int window) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = base;                                   // box c: hd 64 c ..
  uint8_t* vs = base + 2 * kBox64;
  auto qs = [&](int s) { return base + 4 * kBox64 + s * kDkvStage; };
  auto dos = [&](int s) { return qs(s) + 2 * kBox64; };
  uint8_t* p0 = base + 4 * kBox64 + kWgStages * kDkvStage;   // P^T ring
  float* rows_s = reinterpret_cast<float*>(p0 + kPSlots * kPSlot);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s +
                                                  kWgStages * kRowsF32);
  uint64_t* full = kv_full + 1;                         // [kWgStages] each
  uint64_t* empty = full + kWgStages;
  uint64_t* p_full = empty + kWgStages;                 // [kPSlots] each
  uint64_t* p_empty = p_full + kPSlots;

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * kRowTile;
  // query tiles qt0 .. qt1 - 1 of each of the G heads; under causal
  // masking the tiles before the block's first key hold no query that sees
  // it, and under a window those past its last key's window neither
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  const int n_qt = (S + kRowTile - 1) / kRowTile;
  const int qt0 = causal ? min(k0 / kRowTile, n_qt) : 0;
  const int qt1 = query_tile_end(k0, kRowTile, span, n_qt, kRowTile);
  const int per_head = max(qt1 - qt0, 0);
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    for (int i = 0; i < kPSlots; ++i) {
      mbar_init(&p_full[i], 128);           // every thread of dV's warpgroup
      mbar_init(&p_empty[i], 128);          // every thread of dK's
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 256 && n_it > 0) {
      mbar_arrive_expect_tx(kv_full, 4 * kBox64);
      tma_load_4d(ks, &tm_k, kv_full, 0, kh, k0, b);
      tma_load_4d(ks + kBox64, &tm_k, kv_full, 64, kh, k0, b);
      tma_load_4d(vs, &tm_v, kv_full, 0, kh, k0, b);
      tma_load_4d(vs + kBox64, &tm_v, kv_full, 64, kh, k0, b);
      int it = 0;
      for (int gi = 0; gi < G; ++gi) {
        const int hh = kh * G + gi;
        const float* head_rows = rows + static_cast<size_t>(b * H + hh) *
                                            (S_pad / kRowTile) * kRowsF32;
        for (int qt = qt0; qt < qt1; ++qt, ++it) {
          const int s = it % kWgStages;
          mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kDkvStage + kRowsF32 * 4);
          const int q0 = qt * kRowTile;
          tma_load_4d(qs(s), &tm_q, &full[s], 0, hh, q0, b);
          tma_load_4d(qs(s) + kBox64, &tm_q, &full[s], 64, hh, q0, b);
          tma_load_4d(dos(s), &tm_do, &full[s], 0, hh, q0, b);
          tma_load_4d(dos(s) + kBox64, &tm_do, &full[s], 64, hh, q0, b);
          bulk_load(rows_s + s * kRowsF32, head_rows + qt * kRowsF32,
                    kRowsF32 * 4, &full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<kWgConsumerRegs>();
    const DkvTiles tiles{smem_addr(ks), smem_addr(vs), smem_addr(qs(0)),
                         reinterpret_cast<float4*>(p0), rows_s, kv_full, full,
                         empty, p_full, p_empty};
    if (wg == 1) {
      dkdv_consumer<true, WIN>(tiles, k0, qt0, per_head, n_it, T, KV, b, kh,
                          scale_log2, causal, span, dk, scale);
    } else {
      dkdv_consumer<false, WIN>(tiles, k0, qt0, per_head, n_it, T, KV, b, kh,
                           scale_log2, causal, span, dv, 1.0f);
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ rows,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int S, int S_pad,
                            int T, int H, int KV, float scale,
                            float scale_log2, int causal, int window) {
  dkdv_wgmma<false>(tm_q, tm_do, tm_k, tm_v, rows, dk, dv, S, S_pad, T, H, KV,
                    scale, scale_log2, causal, window);
}

// the same under a causal window
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_window_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const float* __restrict__ rows,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, int S,
                                   int S_pad, int T, int H, int KV,
                                   float scale, float scale_log2, int causal,
                                   int window) {
  dkdv_wgmma<true>(tm_q, tm_do, tm_k, tm_v, rows, dk, dv, S, S_pad, T, H, KV,
                   scale, scale_log2, causal, window);
}

// (c') dQ: block (b * H + h, tile of 128 query rows); consumer warpgroup w
// owns rows q0 + 64 w .. + 63.  Query tiles last-first, so that under
// causal masking the blocks with the most keys are issued first.
template <bool WIN>
__device__ __forceinline__ void
dq_wgmma(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
         const CUtensorMap& tm_k, const CUtensorMap& tm_v,
         const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq, int S,
         int S_pad, int T, int H, int KV, float scale, float scale_log2,
         int causal, int window) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                                   // box c: hd 64 c ..
  uint8_t* dos = base + 2 * kBox128;
  auto ks = [&](int s) { return base + 4 * kBox128 + s * kDqStage; };
  auto vs = [&](int s) { return ks(s) + 2 * kBox64; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + 4 * kBox128 +
                                                 kWgStages * kDqStage);
  uint64_t* full = q_full + 1;                          // [kWgStages] each
  uint64_t* empty = full + kWgStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBlock;
  // key tiles lo .. n_tiles - 1: none past the block's last row (causal),
  // none wholly below its first row's window
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  int n_tiles = (T + kRowTile - 1) / kRowTile;
  if (causal) {
    n_tiles = min(n_tiles, (min(q0 + kWgBlock, S) - 1) / kRowTile + 1);
  }
  const int lo = first_key_tile(q0, span, kRowTile);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, 4 * kBox128);
      tma_load_4d(qs, &tm_q, q_full, 0, h, q0, b);
      tma_load_4d(qs + kBox128, &tm_q, q_full, 64, h, q0, b);
      tma_load_4d(dos, &tm_do, q_full, 0, h, q0, b);
      tma_load_4d(dos + kBox128, &tm_do, q_full, 64, h, q0, b);
      for (int jt = lo; jt < n_tiles; ++jt) {
        const int s = (jt - lo) % kWgStages;
        const int j0 = jt * kRowTile;
        mbar_wait(&empty[s], (((jt - lo) / kWgStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kDqStage);
        tma_load_4d(ks(s), &tm_k, &full[s], 0, kh, j0, b);
        tma_load_4d(ks(s) + kBox64, &tm_k, &full[s], 64, kh, j0, b);
        tma_load_4d(vs(s), &tm_v, &full[s], 0, kh, j0, b);
        tma_load_4d(vs(s) + kBox64, &tm_v, &full[s], 64, kh, j0, b);
      }
    }
  } else {
    setmaxnreg_inc<kWgConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_w = q0 + wg * 64;                 // this warpgroup's rows
    const int r_lo = row_w + warp * 16 + g, r_hi = r_lo + 8;
    const uint32_t q_addr = smem_addr(qs) + wg * 64 * 128;
    const uint32_t do_addr = smem_addr(dos) + wg * 64 * 128;
    // the scratch is padded to a multiple of 128 rows: r_lo, r_hi < S_pad
    const float* lo_rows = scratch_rows(rows, bh, S_pad, r_lo);
    const float* hi_rows = scratch_rows(rows, bh, S_pad, r_hi);
    const float lse2[2] = {lo_rows[0], hi_rows[0]};
    const float dsum[2] = {lo_rows[kRowTile], hi_rows[kRowTile]};
    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int jt = lo; jt < n_tiles; ++jt) {
      const int s = (jt - lo) % kWgStages;
      const int j0 = jt * kRowTile;
      mbar_wait(&full[s], ((jt - lo) / kWgStages) & 1);
      // a key tile wholly after this warpgroup's last row (causal) or wholly
      // below its first row's window adds nothing: only its stage is handed
      // back
      if (!(causal && j0 > row_w + 63) &&
          (!WIN || j0 + 63 + span > row_w)) {
        const uint32_t k_addr = smem_addr(ks(s));
        const uint32_t v_addr = smem_addr(vs(s));
        // S = Q K^T and dP = dO V^T: sc[4 j + e] is row r_lo (e < 2) or
        // r_hi, key j0 + 8 j + 2 t + (e & 1)
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_ss(
              sc, desc_sw128(q_addr + (kk / 4) * kBox128 + (kk % 4) * 32, 16, 1024),
              desc_sw128(k_addr + (kk / 4) * kBox64 + (kk % 4) * 32, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_ss(
              dp, desc_sw128(do_addr + (kk / 4) * kBox128 + (kk % 4) * 32, 16, 1024),
              desc_sw128(v_addr + (kk / 4) * kBox64 + (kk % 4) * 32, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        // P = exp2(S scale log2 e - lse log2 e), while dP runs; masked
        // where key > row (causal), past T (zero K rows would still weigh
        // exp2(-lse)) and at key <= row - W (a window's lower edge), to an
        // exact 0
        const bool edge = (causal && j0 + kRowTile - 1 > row_w) ||
                          j0 + kRowTile > T ||
                          (WIN && j0 + span <= row_w + 63);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int rr = (i >> 1) & 1;
          float p = ex2_ftz(fmaf(sc[i], scale_log2, -lse2[rr]));
          if (edge) {
            const int key = j0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = rr ? r_hi : r_lo;
            if (key >= T || (causal && key > row) ||
                (WIN && key + span <= row)) {
              p = 0.0f;
            }
          }
          sc[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = P (dP - D) as hi + lo pairs of bf16 A operands; dQ += dS K,
        // K read MN-major through the transpose bit
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dsum[(i >> 1) & 1];
        uint32_t sh[4][4], sl[4][4];
        make_pairs(sc, sh, sl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = desc_sw128(k_addr + kk * 2048, kBox64, 1024);
          wgmma_m64n128k16_rs(dqa, sh[kk], d, 1);
          wgmma_m64n128k16_rs(dqa, sl[kk], d, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(dqa);

    const size_t q_stride = static_cast<size_t>(H) * 128;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rr ? r_hi : r_lo;
      if (r >= S) continue;
      __nv_bfloat16* row = dq + (static_cast<size_t>(b) * S + r) * q_stride +
                           static_cast<size_t>(h) * 128;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(scale * dqa[i], scale * dqa[i + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ rows,
                          __nv_bfloat16* __restrict__ dq, int S, int S_pad,
                          int T, int H, int KV, float scale, float scale_log2,
                          int causal, int window) {
  dq_wgmma<false>(tm_q, tm_do, tm_k, tm_v, rows, dq, S, S_pad, T, H, KV, scale,
                  scale_log2, causal, window);
}

// the same under a causal window
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_window_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_do,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const float* __restrict__ rows,
                                 __nv_bfloat16* __restrict__ dq, int S,
                                 int S_pad, int T, int H, int KV, float scale,
                                 float scale_log2, int causal, int window) {
  dq_wgmma<true>(tm_q, tm_do, tm_k, tm_v, rows, dq, S, S_pad, T, H, KV, scale,
                 scale_log2, causal, window);
}

// ---------------------------------------------------------------------------
// route 3, bf16, hd 256: route 0's design at hd 256, two warpgroups with
// one thread issuing the loads
// ---------------------------------------------------------------------------

// Two consumer warpgroups and no producer warpgroup: each SM sub-partition
// then holds two warps, which may take 255 registers a thread; a producer
// warpgroup's warps there cap every thread at 168 (setmaxnreg never raised
// the hd-256 forward's consumers past it, csrc/flash_attention.cu).  A
// 64 x 256 f32 accumulator is 128 registers a thread.
constexpr int kH2Threads = 256;
constexpr int kH2Tile = 4 * kBox64;     // 64 rows x 256 bf16: four boxes (32 KB)
// (b''): K and V (64 keys), then per stage Q and dO (64 rows), then the P^T
// ring, then the stages' lse and D rows; barriers after; 1 KB of slack to
// align the base: 231,496 B of the 232,448 a block may take
constexpr int kH2DkvStages = 2;
constexpr int kH2DkvStage = 2 * kH2Tile;
constexpr int kH2DkvBars = 1 + 2 * kH2DkvStages + 2 * kPSlots;
constexpr int kH2DkvSmem = 1024 + 2 * kH2Tile + kH2DkvStages * kH2DkvStage +
                           kPSlots * kPSlot + kH2DkvStages * kRowsF32 * 4 +
                           8 * kH2DkvBars;
// (c''): Q and dO (128 rows, 64 KB each), then per stage K and V of 32 keys
// (16 KB each): 230,456 B
constexpr int kBox32 = 32 * 128;        // a TMA box of 32 rows x 64 bf16
constexpr int kH2DqKeys = 32;
constexpr int kH2DqStages = 3;
constexpr int kH2DqStage = 2 * 4 * kBox32;
constexpr int kH2DqBars = 1 + 2 * kH2DqStages;
constexpr int kH2DqSmem = 1024 + 8 * kBox128 + kH2DqStages * kH2DqStage +
                          8 * kH2DqBars;
static_assert(kH2DkvSmem <= 232448 && kH2DqSmem <= 232448,
              "a block takes at most 227 KB of shared memory");

// (b'')'s consumer warpgroups, keys k0 .. k0 + 63: dkdv_consumer's roles at
// hd 256.  dV's (GRAD_K false): S^T = K Q^T (m64n64k16, 16 k16 steps over
// the four 64-wide boxes), P^T, handed to dK's warpgroup in register order
// through the P^T ring, then dV += P^T dO (m64n256k16, P^T as hi + lo pairs
// from registers, dO MN-major, its four boxes LBO apart).  dK's: dP^T = V
// dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.  Each holds one 64 x 256
// accumulator (128 registers) beside one 64 x 64 score tile (32).  The
// loads are issued by thread 0 of dK's warpgroup (`load_step(it)` loads
// step it into stage it % 2): at the end of step it, once both warpgroups
// have read the stage, it loads step it + 2 there.  dK's warpgroup runs
// behind dV's (it waits for P^T), so that wait rarely blocks; a thread of
// dV's would hold its warpgroup until dK's had finished the step.
template <bool GRAD_K, bool WIN, typename Load>
__device__ __forceinline__ void dkdv_hd256_consumer(
    const DkvTiles& tl, const Load& load_step, int k0, int qt0, int per_head,
    int n_it, int T, int KV, int b, int kh, float scale_log2, int causal,
    int span, __nv_bfloat16* out, float mul) {
  using namespace hopper;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;            // accumulator rows g, g + 8
  const int me = threadIdx.x % 128;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  if (n_it > 0) mbar_wait(tl.kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kH2DkvStages, slot = it % kPSlots;
    const uint32_t ph = (it / kH2DkvStages) & 1;
    const uint32_t pph = (it / kPSlots) & 1;
    const int q0 = (qt0 + it % per_head) * kRowTile;
    mbar_wait(&tl.full[s], ph);
    const uint32_t q_addr = tl.q0_addr + s * kH2DkvStage;
    const uint32_t do_addr = q_addr + kH2Tile;
    const float* rs_ = tl.rows_s + s * kRowsF32;
    float4* ring = tl.p0 + slot * (kPSlot / 16);
    // x[4 j + e] is key key_lo (e < 2) or key_lo + 8, query q0 + 8 j + 2 t +
    // (e & 1): S^T, then P^T (dV's) or dP^T, then dS^T (dK's)
    float x[32];
    const uint32_t a_addr = GRAD_K ? tl.v_addr : tl.k_addr;
    const uint32_t b_addr = GRAD_K ? do_addr : q_addr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox64 + (kk % 4) * 32;
      wgmma_m64n64k16_ss(x, desc_sw128(a_addr + off, 16, 1024),
                         desc_sw128(b_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if constexpr (!GRAD_K) {
      // as route 0: rows past S carry lse = +inf (P = 0), keys past T are
      // never stored; P is masked to an exact 0 on the diagonal tile and at
      // a window's lower edge
      const bool diag = causal && k0 + 63 > q0;
      const bool wedge = WIN && q0 + 63 >= k0 + span;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rs_ + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = ex2_ftz(fmaf(x[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (diag || wedge) {
            const int key = key_lo + (e & 2) * 4;
            const int row = q0 + 8 * j + 2 * t + (e & 1);
            if ((diag && key > row) || (WIN && key + span <= row)) {
              p = 0.0f;
            }
          }
          x[i] = p;
        }
      }
      mbar_wait(&tl.p_empty[slot], pph ^ 1);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        ring[c * 128 + me] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2],
                                         x[4 * c + 3]);
      }
      mbar_arrive(&tl.p_full[slot]);
    } else {
      mbar_wait(&tl.p_full[slot], pph);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = ring[j * 128 + me];
        const float2 d2 =
            *reinterpret_cast<const float2*>(rs_ + kRowTile + 8 * j + 2 * t);
        x[4 * j] = p.x * (x[4 * j] - d2.x);
        x[4 * j + 1] = p.y * (x[4 * j + 1] - d2.y);
        x[4 * j + 2] = p.z * (x[4 * j + 2] - d2.x);
        x[4 * j + 3] = p.w * (x[4 * j + 3] - d2.y);
      }
      mbar_arrive(&tl.p_empty[slot]);
    }
    uint32_t ah[4][4], al[4][4];
    make_pairs(x, ah, al);
    const uint32_t c_addr = GRAD_K ? q_addr : do_addr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc_sw128(c_addr + kk * 2048, kBox64, 1024);
      wgmma_m64n256k16_rs(acc, ah[kk], d, 1);
      wgmma_m64n256k16_rs(acc, al[kk], d, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&tl.empty[s]);
    if constexpr (GRAD_K) {
      if (me == 0 && it + kH2DkvStages < n_it) {
        mbar_wait(&tl.empty[s], ph);
        load_step(it + kH2DkvStages);
      }
      __syncwarp();
    }
  }
  fence_regs(acc);

  const size_t kv_stride = static_cast<size_t>(KV) * 256;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key_lo + 8 * rr;
    if (key >= T) continue;
    __nv_bfloat16* row = out + (static_cast<size_t>(b) * T + key) * kv_stride +
                         static_cast<size_t>(kh) * 256;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(mul * acc[i], mul * acc[i + 1]);
    }
  }
}

// (b'') dK, dV at hd 256: block (b * KV + kh, tile of 64 keys); warpgroup 0
// accumulates dV, warpgroup 1 dK (dkdv_hd256_consumer).  K and V (64 x
// 256) are loaded once; 64-row Q and dO tiles with their 64 lse and D rows
// stream through a two-stage ring for each of the G query heads in turn.
// Key tiles in blockIdx.y order, the heaviest first (as route 0).
template <bool WIN>
__device__ __forceinline__ void
dkdv_hd256(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
           const CUtensorMap& tm_k, const CUtensorMap& tm_v,
           const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int S, int S_pad, int T, int H,
           int KV, float scale, float scale_log2, int causal, int window) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = base;                                   // box c: hd 64 c ..
  uint8_t* vs = base + kH2Tile;
  auto qs = [&](int s) { return base + 2 * kH2Tile + s * kH2DkvStage; };
  auto dos = [&](int s) { return qs(s) + kH2Tile; };
  uint8_t* p0 = base + 2 * kH2Tile + kH2DkvStages * kH2DkvStage;  // P^T ring
  float* rows_s = reinterpret_cast<float*>(p0 + kPSlots * kPSlot);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s +
                                                  kH2DkvStages * kRowsF32);
  uint64_t* full = kv_full + 1;                         // [kH2DkvStages] each
  uint64_t* empty = full + kH2DkvStages;
  uint64_t* p_full = empty + kH2DkvStages;              // [kPSlots] each
  uint64_t* p_empty = p_full + kPSlots;

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * kRowTile;
  // query tiles qt0 .. qt1 - 1 of each of the G heads, as route 0
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  const int n_qt = (S + kRowTile - 1) / kRowTile;
  const int qt0 = causal ? min(k0 / kRowTile, n_qt) : 0;
  const int qt1 = query_tile_end(k0, kRowTile, span, n_qt, kRowTile);
  const int per_head = max(qt1 - qt0, 0);
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kH2DkvStages; ++s) {
      mbar_init(&full[s], 1);               // the loading thread's expect_tx
      mbar_init(&empty[s], 8);              // one arrival per warp
    }
    for (int i = 0; i < kPSlots; ++i) {
      mbar_init(&p_full[i], 128);           // every thread of dV's warpgroup
      mbar_init(&p_empty[i], 128);          // every thread of dK's
    }
    fence_barrier_init();
  }
  __syncthreads();

  // step it: query head kh G + it / per_head, query tile qt0 + it % per_head
  auto load_step = [&](int it) {
    const int s = it % kH2DkvStages;
    const int hh = kh * G + it / per_head;
    const int qt = qt0 + it % per_head;
    mbar_arrive_expect_tx(&full[s], kH2DkvStage + kRowsF32 * 4);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(qs(s) + c * kBox64, &tm_q, &full[s], 64 * c, hh,
                  qt * kRowTile, b);
      tma_load_4d(dos(s) + c * kBox64, &tm_do, &full[s], 64 * c, hh,
                  qt * kRowTile, b);
    }
    bulk_load(rows_s + s * kRowsF32,
              rows + (static_cast<size_t>(b * H + hh) * (S_pad / kRowTile) +
                      qt) * kRowsF32,
              kRowsF32 * 4, &full[s]);
  };
  if (threadIdx.x == 128 && n_it > 0) {
    mbar_arrive_expect_tx(kv_full, 2 * kH2Tile);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(ks + c * kBox64, &tm_k, kv_full, 64 * c, kh, k0, b);
      tma_load_4d(vs + c * kBox64, &tm_v, kv_full, 64 * c, kh, k0, b);
    }
    for (int it = 0; it < min(kH2DkvStages, n_it); ++it) load_step(it);
  }
  __syncwarp();

  const DkvTiles tiles{smem_addr(ks), smem_addr(vs), smem_addr(qs(0)),
                       reinterpret_cast<float4*>(p0), rows_s, kv_full, full,
                       empty, p_full, p_empty};
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 1) {
    dkdv_hd256_consumer<true, WIN>(tiles, load_step, k0, qt0, per_head, n_it,
                                   T, KV, b, kh, scale_log2, causal, span, dk,
                                   scale);
  } else {
    dkdv_hd256_consumer<false, WIN>(tiles, load_step, k0, qt0, per_head, n_it,
                                    T, KV, b, kh, scale_log2, causal, span, dv,
                                    1.0f);
  }
}

__global__ void __launch_bounds__(kH2Threads, 1)
flash_bwd_dkdv_wgmma_hd256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const float* __restrict__ rows,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int S,
                                  int S_pad, int T, int H, int KV, float scale,
                                  float scale_log2, int causal, int window) {
  dkdv_hd256<false>(tm_q, tm_do, tm_k, tm_v, rows, dk, dv, S, S_pad, T, H, KV,
                    scale, scale_log2, causal, window);
}

// the same under a causal window
__global__ void __launch_bounds__(kH2Threads, 1)
flash_bwd_dkdv_wgmma_hd256_window_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ rows,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
    int S_pad, int T, int H, int KV, float scale, float scale_log2,
    int causal, int window) {
  dkdv_hd256<true>(tm_q, tm_do, tm_k, tm_v, rows, dk, dv, S, S_pad, T, H, KV,
                   scale, scale_log2, causal, window);
}

// (c'') dQ at hd 256: block (b * H + h, tile of 128 query rows); warpgroup w
// owns rows q0 + 64 w .. + 63, Q and dO loaded once.  32-key tiles of K and
// V stream through a three-stage ring, loaded by thread 0: at the end of
// tile jt, once both warpgroups have read its stage, tile jt + 3.  S = Q
// K^T and dP = dO V^T (m64n32k16, 16 registers each), P, dS = P (dP - D),
// dQ += dS K (m64n256k16 over two k16 steps, dS as hi + lo pairs, K
// MN-major): 128 accumulator registers beside the two score tiles.  Query
// tiles last-first, so that under causal masking the blocks with the most
// keys are issued first; a key tile wholly after a warpgroup's rows
// (causal) or below its first row's window is only handed back.
template <bool WIN>
__device__ __forceinline__ void
dq_hd256(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
         const CUtensorMap& tm_k, const CUtensorMap& tm_v,
         const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq, int S,
         int S_pad, int T, int H, int KV, float scale, float scale_log2,
         int causal, int window) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                                   // box c: hd 64 c ..
  uint8_t* dos = base + 4 * kBox128;
  auto ks = [&](int s) { return base + 8 * kBox128 + s * kH2DqStage; };
  auto vs = [&](int s) { return ks(s) + 4 * kBox32; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + 8 * kBox128 +
                                                 kH2DqStages * kH2DqStage);
  uint64_t* full = q_full + 1;                          // [kH2DqStages] each
  uint64_t* empty = full + kH2DqStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBlock;
  // key tiles lo .. n_tiles - 1: none past the block's last row (causal),
  // none wholly below its first row's window
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  int n_tiles = (T + kH2DqKeys - 1) / kH2DqKeys;
  if (causal) {
    n_tiles = min(n_tiles, (min(q0 + kWgBlock, S) - 1) / kH2DqKeys + 1);
  }
  const int lo = first_key_tile(q0, span, kH2DqKeys);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kH2DqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  auto load_kv = [&](int jt) {
    const int s = (jt - lo) % kH2DqStages;
    mbar_arrive_expect_tx(&full[s], kH2DqStage);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(ks(s) + c * kBox32, &tm_k, &full[s], 64 * c, kh,
                  jt * kH2DqKeys, b);
      tma_load_4d(vs(s) + c * kBox32, &tm_v, &full[s], 64 * c, kh,
                  jt * kH2DqKeys, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_full, 8 * kBox128);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(qs + c * kBox128, &tm_q, q_full, 64 * c, h, q0, b);
      tma_load_4d(dos + c * kBox128, &tm_do, q_full, 64 * c, h, q0, b);
    }
    for (int jt = lo; jt < min(lo + kH2DqStages, n_tiles); ++jt) load_kv(jt);
  }
  __syncwarp();

  // warp-uniform to the compiler (a broadcast from lane 0), so that the
  // wgmma descriptors derived from it are computed in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_w = q0 + wg * 64;                   // this warpgroup's rows
  const int r_lo = row_w + warp * 16 + g, r_hi = r_lo + 8;
  const uint32_t q_addr = smem_addr(qs) + wg * 64 * 128;
  const uint32_t do_addr = smem_addr(dos) + wg * 64 * 128;
  // the scratch is padded to a multiple of 128 rows: r_lo, r_hi < S_pad
  const float* lo_rows = scratch_rows(rows, bh, S_pad, r_lo);
  const float* hi_rows = scratch_rows(rows, bh, S_pad, r_hi);
  const float lse2[2] = {lo_rows[0], hi_rows[0]};
  const float dsum[2] = {lo_rows[kRowTile], hi_rows[kRowTile]};
  float dqa[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dqa[i] = 0.0f;

  mbar_wait(q_full, 0);
  for (int jt = lo; jt < n_tiles; ++jt) {
    const int s = (jt - lo) % kH2DqStages;
    const uint32_t ph = ((jt - lo) / kH2DqStages) & 1;
    const int j0 = jt * kH2DqKeys;
    mbar_wait(&full[s], ph);
    if (!(causal && j0 > row_w + 63) &&
        (!WIN || j0 + kH2DqKeys - 1 + span > row_w)) {
      const uint32_t k_addr = smem_addr(ks(s));
      const uint32_t v_addr = smem_addr(vs(s));
      // S = Q K^T and dP = dO V^T: sc[4 j + e] is row r_lo (e < 2) or
      // r_hi, key j0 + 8 j + 2 t + (e & 1)
      float sc[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const uint32_t k32 = (kk % 4) * 32;
        wgmma_m64n32k16_ss(
            sc, desc_sw128(q_addr + (kk / 4) * kBox128 + k32, 16, 1024),
            desc_sw128(k_addr + (kk / 4) * kBox32 + k32, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const uint32_t k32 = (kk % 4) * 32;
        wgmma_m64n32k16_ss(
            dp, desc_sw128(do_addr + (kk / 4) * kBox128 + k32, 16, 1024),
            desc_sw128(v_addr + (kk / 4) * kBox32 + k32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      // P = exp2(S scale log2 e - lse log2 e), while dP runs; masked to an
      // exact 0 where key > row (causal), past T and at key <= row - W
      const bool edge = (causal && j0 + kH2DqKeys - 1 > row_w) ||
                        j0 + kH2DqKeys > T ||
                        (WIN && j0 + span <= row_w + 63);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int rr = (i >> 1) & 1;
        float p = ex2_ftz(fmaf(sc[i], scale_log2, -lse2[rr]));
        if (edge) {
          const int key = j0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = rr ? r_hi : r_lo;
          if (key >= T || (causal && key > row) ||
              (WIN && key + span <= row)) {
            p = 0.0f;
          }
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - D) as hi + lo pairs of bf16 A operands; dQ += dS K,
      // K read MN-major (32 keys a box, its four hd boxes LBO apart)
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] *= dp[i] - dsum[(i >> 1) & 1];
      uint32_t sh[2][4], sl[2][4];
      make_pairs(sc, sh, sl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t d = desc_sw128(k_addr + kk * 2048, kBox32, 1024);
        wgmma_m64n256k16_rs(dqa, sh[kk], d, 1);
        wgmma_m64n256k16_rs(dqa, sl[kk], d, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && jt + kH2DqStages < n_tiles) {
      mbar_wait(&empty[s], ph);
      load_kv(jt + kH2DqStages);
    }
    __syncwarp();
  }
  fence_regs(dqa);

  const size_t q_stride = static_cast<size_t>(H) * 256;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rr ? r_hi : r_lo;
    if (r >= S) continue;
    __nv_bfloat16* row = dq + (static_cast<size_t>(b) * S + r) * q_stride +
                         static_cast<size_t>(h) * 256;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(scale * dqa[i], scale * dqa[i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kH2Threads, 1)
flash_bwd_dq_wgmma_hd256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const float* __restrict__ rows,
                                __nv_bfloat16* __restrict__ dq, int S,
                                int S_pad, int T, int H, int KV, float scale,
                                float scale_log2, int causal, int window) {
  dq_hd256<false>(tm_q, tm_do, tm_k, tm_v, rows, dq, S, S_pad, T, H, KV,
                  scale, scale_log2, causal, window);
}

// the same under a causal window
__global__ void __launch_bounds__(kH2Threads, 1)
flash_bwd_dq_wgmma_hd256_window_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ rows,
    __nv_bfloat16* __restrict__ dq, int S, int S_pad, int T, int H, int KV,
    float scale, float scale_log2, int causal, int window) {
  dq_hd256<true>(tm_q, tm_do, tm_k, tm_v, rows, dq, S, S_pad, T, H, KV, scale,
                 scale_log2, causal, window);
}

// ---------------------------------------------------------------------------
// route 2, f32: FMA
// ---------------------------------------------------------------------------

template <int HD>
struct BwdF32Smem {
  // keys a (b) block and a (c) step: 64, or 32 at hd 256, where four
  // transposed 64-row tiles alone would take 266 KB
  static constexpr int kKeys = HD == 256 ? 32 : kTileF32;
  static constexpr int LDT = kTileF32 + 1;    // query tiles stored transposed
  static constexpr int LDK = kKeys + 1;       // key tiles stored transposed
  static constexpr int LDP = kTileF32 + 16;   // P / dS rows: 16 banks apart
  static constexpr int kT = HD * LDT;
  static constexpr int kK = HD * LDK;
  // (b): K^T, V^T, Q^T, dO^T, P, dS (kKeys rows each); (c): Q^T, dO^T, K^T,
  // V^T, dS (64 rows); 221,184 B each at hd 256
  static constexpr int kBytesDkv = (2 * kK + 2 * kT + 2 * kKeys * LDP) * 4;
  static constexpr int kBytesDq = (2 * kT + 2 * kK + kTileF32 * LDP) * 4;
};

// rows r0 .. r0 + ROWS - 1 (zero past n) of a (.., hd) tensor whose rows
// are `stride` apart, into dst[c * LD + r] (transposed)
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       size_t stride, int r0, int n) {
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreadsF32) {
    const int r = i / HD, c = i % HD;
    dst[c * LD + r] = r0 + r < n ? src[(r0 + r) * stride + c] : 0.0f;
  }
}

// acc[a][j] = sum_d x[d][ty + 16 a] y[d][tx + 16 j] over the transposed
// tiles x (LDX apart) and y (LDY apart), summed in f64 and rounded once.
// dS = P (dP - D) cancels: where a row sees one key, P = 1 and the exact dQ
// is 0, and an f32 sum of hd products (D's in another order) leaves dP - D
// several ulps of |dP| from 0, up to 1e-4 of dQ's scale at hd 128
// (scripts/flash_bwd_f32_rows.py); f64 sums, here and in D, leave one.
template <int HD, int LDX, int LDY, int A, int J>
__device__ __forceinline__ void tile_dot(float acc[A][J], const float* x,
                                         const float* y, int tx, int ty) {
  double sum[A][J];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int j = 0; j < J; ++j) sum[a][j] = 0.0;
  }
  // unrolled by 2: by 4, ptxas spills 4 bytes of the windowed hd-32 dK / dV
#pragma unroll 2
  for (int d = 0; d < HD; ++d) {
    double xv[A], yv[J];
#pragma unroll
    for (int a = 0; a < A; ++a) xv[a] = x[d * LDX + ty + 16 * a];
#pragma unroll
    for (int j = 0; j < J; ++j) yv[j] = y[d * LDY + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int j = 0; j < J; ++j) sum[a][j] = fma(xv[a], yv[j], sum[a][j]);
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int j = 0; j < J; ++j) acc[a][j] = static_cast<float>(sum[a][j]);
  }
}

// (b) dK, dV: block (b * KV + kh, tile of kKeys keys); thread (ty, tx) owns
// keys ty + 16 a and, of the kKeys x 64 score tiles, queries tx + 16 j; of
// dK and dV, columns tx + 16 c
template <int HD, bool WIN>
__device__ __forceinline__ void
dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         float* __restrict__ dk, float* __restrict__ dv, int S, int T, int H,
         int KV, float scale, int causal, int window) {
  using SM = BwdF32Smem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LDT = SM::LDT, LDK = SM::LDK, LDP = SM::LDP;
  constexpr int KEYS = SM::kKeys;
  constexpr int A = KEYS / 16;                // keys per thread
  constexpr int DC = HD / 16;
  float* kt = reinterpret_cast<float*>(bwd_smem);
  float* vt = kt + SM::kK;
  float* qt = vt + SM::kK;
  float* ot = qt + SM::kT;
  float* ps = ot + SM::kT;                    // [KEYS][LDP]
  float* dss = ps + KEYS * LDP;               // [KEYS][LDP]

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * KEYS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t kv_off = static_cast<size_t>(b) * T * kv_stride +
                        static_cast<size_t>(kh) * HD;
  load_t<HD, LDK, KEYS>(kt, k + kv_off, kv_stride, k0, T);
  load_t<HD, LDK, KEYS>(vt, v + kv_off, kv_stride, k0, T);

  float dk_acc[A][DC], dv_acc[A][DC];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;
  }
  // query tiles qt0 .. qt1 - 1: from the block's first key (causal) to its
  // last key's window
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  const int n_qt = (S + kTileF32 - 1) / kTileF32;
  const int qt0 = causal ? min(k0 / kTileF32, n_qt) : 0;
  const int qt1 = query_tile_end(k0, KEYS, span, n_qt, kTileF32);
  for (int gi = 0; gi < G; ++gi) {
    const int hh = kh * G + gi;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(hh) * HD;
    const size_t row_off = (static_cast<size_t>(b) * H + hh) * S;
    for (int qt_i = qt0; qt_i < qt1; ++qt_i) {
      const int q0 = qt_i * kTileF32;
      __syncthreads();                  // the last step's tiles are read
      load_t<HD, LDT, kTileF32>(qt, q + q_off, q_stride, q0, S);
      load_t<HD, LDT, kTileF32>(ot, dout + q_off, q_stride, q0, S);
      float ls[4], dd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        ls[j] = qpos < S ? lse[row_off + qpos] : 0.0f;
        dd[j] = qpos < S ? dsum[row_off + qpos] : 0.0f;
      }
      __syncthreads();
      float s[A][4], dp[A][4];
      tile_dot<HD, LDK, LDT, A, 4>(s, kt, qt, tx, ty);     // S^T = K Q^T
      tile_dot<HD, LDK, LDT, A, 4>(dp, vt, ot, tx, ty);    // dP^T = V dO^T
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int key = k0 + ty + 16 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool live = qpos < S && key < T &&
                            !(causal && key > qpos) &&
                            (!WIN || key + span > qpos);
          const float p = live ? expf(s[a][j] * scale - ls[j]) : 0.0f;
          ps[(ty + 16 * a) * LDP + tx + 16 * j] = p;
          dss[(ty + 16 * a) * LDP + tx + 16 * j] = p * (dp[a][j] - dd[j]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q, over the tile's 64 queries
#pragma unroll 4
      for (int j = 0; j < kTileF32; ++j) {
        float pv[A], sv[A], ov[DC], qv[DC];
#pragma unroll
        for (int a = 0; a < A; ++a) {
          pv[a] = ps[(ty + 16 * a) * LDP + j];
          sv[a] = dss[(ty + 16 * a) * LDP + j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = ot[(tx + 16 * c) * LDT + j];
          qv[c] = qt[(tx + 16 * c) * LDT + j];
        }
#pragma unroll
        for (int a = 0; a < A; ++a) {
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
  for (int a = 0; a < A; ++a) {
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

template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int T, int H, int KV, float scale, int causal,
                          int window) {
  dkdv_f32<HD, false>(q, k, v, dout, lse, dsum, dk, dv, S, T, H, KV, scale,
                      causal, window);
}

// the same under a causal window
template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkdv_f32_window_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ dsum,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int S, int T, int H,
                                 int KV, float scale, int causal, int window) {
  dkdv_f32<HD, true>(q, k, v, dout, lse, dsum, dk, dv, S, T, H, KV, scale,
                     causal, window);
}

// (c) dQ: block (b * H + h, 64-row query tile); thread (ty, tx) owns rows
// ty + 16 a and, of each 64 x kKeys score tile, keys tx + 16 j; of dQ,
// columns tx + 16 c
template <int HD, bool WIN>
__device__ __forceinline__ void
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dsum,
       float* __restrict__ dq, int S, int T, int H, int KV, float scale,
       int causal, int window) {
  using SM = BwdF32Smem<HD>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  constexpr int LDT = SM::LDT, LDK = SM::LDK, LDP = SM::LDP;
  constexpr int KEYS = SM::kKeys;
  constexpr int J = KEYS / 16;                // keys per thread
  constexpr int DC = HD / 16;
  float* qt = reinterpret_cast<float*>(bwd_smem);
  float* ot = qt + SM::kT;
  float* kt = ot + SM::kT;
  float* vt = kt + SM::kK;
  float* dss = vt + SM::kK;                   // [64][LDP]

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
  load_t<HD, LDT, kTileF32>(qt, q + q_off, q_stride, q0, S);
  load_t<HD, LDT, kTileF32>(ot, dout + q_off, q_stride, q0, S);
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

  // key tiles lo .. n_tiles - 1: none past the block's last row (causal),
  // none wholly below its first row's window
  const int span = WIN ? window_span(causal, window) : kNoSpan;
  int n_tiles = (T + KEYS - 1) / KEYS;
  if (causal) {
    n_tiles = min(n_tiles, (min(q0 + kTileF32, S) - 1) / KEYS + 1);
  }
  for (int jt = first_key_tile(q0, span, KEYS); jt < n_tiles; ++jt) {
    const int j0 = jt * KEYS;
    __syncthreads();                    // the last step's tiles are read
    load_t<HD, LDK, KEYS>(kt, k + kv_off, kv_stride, j0, T);
    load_t<HD, LDK, KEYS>(vt, v + kv_off, kv_stride, j0, T);
    __syncthreads();
    float s[4][J], dp[4][J];
    tile_dot<HD, LDT, LDK, 4, J>(s, qt, kt, tx, ty);       // S = Q K^T
    tile_dot<HD, LDT, LDK, 4, J>(dp, ot, vt, tx, ty);      // dP = dO V^T
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int key = j0 + tx + 16 * j;
        const bool live = qpos < S && key < T && !(causal && key > qpos) &&
                          (!WIN || key + span > qpos);
        const float p = live ? expf(s[a][j] * scale - ls[a]) : 0.0f;
        dss[(ty + 16 * a) * LDP + tx + 16 * j] = p * (dp[a][j] - dd[a]);
      }
    }
    __syncthreads();
    // dQ += dS K, over the tile's keys
#pragma unroll 4
    for (int j = 0; j < KEYS; ++j) {
      float sv[4], kv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = dss[(ty + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = kt[(tx + 16 * c) * LDK + j];
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

template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, float* __restrict__ dq,
                        int S, int T, int H, int KV, float scale, int causal,
                        int window) {
  dq_f32<HD, false>(q, k, v, dout, lse, dsum, dq, S, T, H, KV, scale, causal,
                    window);
}

// the same under a causal window
template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_window_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               float* __restrict__ dq, int S, int T, int H,
                               int KV, float scale, int causal, int window) {
  dq_f32<HD, true>(q, k, v, dout, lse, dsum, dq, S, T, H, KV, scale, causal,
                   window);
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
  int window;                         // 0 for none
};

// route 1: (b), then (c)
template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const auto dkdv = a.window ? flash_bwd_dkdv_bf16_window_kernel<HD>
                             : flash_bwd_dkdv_bf16_kernel<HD>;
  const int e1 = set_smem(dkdv, DkvSmem<HD>::kBytes);
  if (e1 != 0) return e1;
  dkdv<<<dim3(a.B * a.KV, (a.T + kKeysDkv - 1) / kKeysDkv), kThreadsMma,
         DkvSmem<HD>::kBytes, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.S, a.T, a.H, a.KV,
          a.scale, a.causal, a.window);
  const int e2 = static_cast<int>(cudaGetLastError());
  if (e2 != 0) return e2;
  const auto dq = a.window ? flash_bwd_dq_bf16_window_kernel<HD>
                           : flash_bwd_dq_bf16_kernel<HD>;
  const int e3 = set_smem(dq, DqSmem<HD>::kBytes);
  if (e3 != 0) return e3;
  dq<<<dim3(a.B * a.H, (a.S + kRowsDq - 1) / kRowsDq), kThreadsMma,
       DqSmem<HD>::kBytes, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<bf*>(a.dq), a.S, a.T, a.H, a.KV, a.scale, a.causal,
          a.window);
  return static_cast<int>(cudaGetLastError());
}

// A bf16 tensor map over the real 4-D layout (hd, heads, seq, batch) of q,
// dout (heads H, seq S) or k, v (KV, T), in boxes of 64 hd x `rows` rows.
int bwd_map(CUtensorMap* map, const void* base, int hd, int heads, int seq,
            int B, int rows) {
  const uint64_t dim[4] = {static_cast<uint64_t>(hd),
                           static_cast<uint64_t>(heads),
                           static_cast<uint64_t>(seq),
                           static_cast<uint64_t>(B)};
  const uint64_t str[3] = {2ull * hd, 2ull * hd * heads,
                           2ull * hd * heads * seq};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return hopper::make_tensor_map_bf16(map, base, 4, dim, str, box);
}

// routes 0 (hd 128) and 3 (hd 256): (a'), then dK / dV ((b') or (b'')) and
// dQ ((c') or (c'')) on tensor maps: 64-row Q and dO tiles past 64 keys,
// K and V tiles (64 keys, or 32 at hd 256) past 128 query rows
template <int HD>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr bool kHd256 = HD == 256;
  const int S_pad = (a.S + kWgBlock - 1) / kWgBlock * kWgBlock;
  float* rows = static_cast<float*>(a.dsum);
  const long long n_rows = static_cast<long long>(a.B) * S_pad * a.H;
  const long long blocks = (n_rows + kDotRows - 1) / kDotRows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_rows_kernel<HD><<<static_cast<unsigned>(blocks), 32 * kDotRows, 0,
                              stream>>>(
      static_cast<const bf*>(a.out), static_cast<const bf*>(a.dout),
      static_cast<const float*>(a.lse), rows, a.S, S_pad, a.H, n_rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // dQ's K and V tiles: 64 keys at hd 128, 32 at hd 256
  constexpr int kDqKeys = kHd256 ? kH2DqKeys : kRowTile;
  CUtensorMap q64, do64, q128, do128, k64, v64, kdq, vdq;
  const struct { CUtensorMap* map; const void* base; bool q; int rows; } maps[8] = {
      {&q64, a.q, true, kRowTile},     {&do64, a.dout, true, kRowTile},
      {&q128, a.q, true, kWgBlock},    {&do128, a.dout, true, kWgBlock},
      {&k64, a.k, false, kRowTile},    {&v64, a.v, false, kRowTile},
      {&kdq, a.k, false, kDqKeys},     {&vdq, a.v, false, kDqKeys}};
  for (const auto& m : maps) {
    err = bwd_map(m.map, m.base, HD, m.q ? a.H : a.KV, m.q ? a.S : a.T, a.B,
                  m.rows);
    if (err != 0) return err;
  }
  const float scale_log2 = a.scale * kLog2e;
  const auto dkdv =
      kHd256 ? (a.window ? flash_bwd_dkdv_wgmma_hd256_window_kernel
                         : flash_bwd_dkdv_wgmma_hd256_kernel)
             : (a.window ? flash_bwd_dkdv_wgmma_window_kernel
                         : flash_bwd_dkdv_wgmma_kernel);
  const int threads = kHd256 ? kH2Threads : kWgThreads;
  const int dkdv_smem = kHd256 ? kH2DkvSmem : kDkvSmem;
  err = set_smem(dkdv, dkdv_smem);
  if (err != 0) return err;
  dkdv<<<dim3(a.B * a.KV, (a.T + kRowTile - 1) / kRowTile), threads,
         dkdv_smem, stream>>>(
      q64, do64, k64, v64, rows, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.S, S_pad, a.T, a.H, a.KV, a.scale, scale_log2,
      a.causal, a.window);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const auto dq =
      kHd256 ? (a.window ? flash_bwd_dq_wgmma_hd256_window_kernel
                         : flash_bwd_dq_wgmma_hd256_kernel)
             : (a.window ? flash_bwd_dq_wgmma_window_kernel
                         : flash_bwd_dq_wgmma_kernel);
  const int dq_smem = kHd256 ? kH2DqSmem : kDqSmem;
  err = set_smem(dq, dq_smem);
  if (err != 0) return err;
  dq<<<dim3(a.B * a.H, S_pad / kWgBlock), threads, dq_smem, stream>>>(
      q128, do128, kdq, vdq, rows, static_cast<bf*>(a.dq), a.S, S_pad, a.T,
      a.H, a.KV, a.scale, scale_log2, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  using SM = BwdF32Smem<HD>;
  const auto dkdv = a.window ? flash_bwd_dkdv_f32_window_kernel<HD>
                             : flash_bwd_dkdv_f32_kernel<HD>;
  const int e1 = set_smem(dkdv, SM::kBytesDkv);
  if (e1 != 0) return e1;
  dkdv<<<dim3(a.B * a.KV, (a.T + SM::kKeys - 1) / SM::kKeys), kThreadsF32,
         SM::kBytesDkv, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S, a.T, a.H,
          a.KV, a.scale, a.causal, a.window);
  const int e2 = static_cast<int>(cudaGetLastError());
  if (e2 != 0) return e2;
  const auto dq = a.window ? flash_bwd_dq_f32_window_kernel<HD>
                           : flash_bwd_dq_f32_kernel<HD>;
  const int e3 = set_smem(dq, SM::kBytesDq);
  if (e3 != 0) return e3;
  dq<<<dim3(a.B * a.H, (a.S + kTileF32 - 1) / kTileF32), kThreadsF32,
         SM::kBytesDq, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<float*>(a.dq), a.S, a.T, a.H, a.KV, a.scale, a.causal,
          a.window);
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

// Launches the route's kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success).  The caller checks devices, dtypes
// and contiguity, and that the pointers are 16-byte aligned; B, S, T, H >= 1
// and H % KV == 0.  lse (B, H, S) f32 from the forward.  dtype 0 = bf16, 1
// = f32.  route 0 = wgmma (bf16, hd 128), 1 = mma_sync (bf16, hd 32 or
// 64), 2 = fma (f32, hd 32, 64, 128 or 256), 3 = hd256 (bf16, hd 256); a
// route that the dtype and hd do not select is refused.  dsum is f32
// scratch of 2 B H S_pad floats (S_pad = S rounded up to a multiple of
// 128; kernels/flash_attention.py::flash_bwd_scratch allocates it): routes
// 0 and 3's (a') fill it with lse log2 e and D, 64 rows at a time; routes
// 1 and 2's (a) fill its first B H S floats with D (B, H, S).  window: 0 for
// none, else the forward's causal window W >= 1, with every query row
// seeing a key (S <= T + W - 1); lse must be the windowed forward's.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* dsum, int B, int S, int T,
                                   int H, int KV, int hd, int dtype,
                                   int causal, float scale, int route,
                                   int window, void* stream) {
  const bool fits =
      (route == 0 && dtype == 0 && hd == 128) ||
      (route == 1 && dtype == 0 && (hd == 32 || hd == 64)) ||
      (route == 2 && dtype == 1 &&
       (hd == 32 || hd == 64 || hd == 128 || hd == 256)) ||
      (route == 3 && dtype == 0 && hd == 256);
  const bool window_ok =
      window == 0 || (window > 0 && causal &&
                      static_cast<long long>(S) <=
                          static_cast<long long>(T) + window - 1);
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      !fits || !window_ok || (S + 63) / 64 > 65535 ||
      (T + 63) / 64 > 65535 ||
      (route == 2 && hd == 256 && (T + 31) / 32 > 65535) ||
      static_cast<long long>(B) * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, out, lse, dout, dq, dk, dv, dsum,
               B, S, T, H, KV, causal, scale, window};
  if (route == 0) return launch_wgmma<128>(a, s);
  if (route == 3) return launch_wgmma<256>(a, s);
  const int e = dtype == 0 ? launch_dot<__nv_bfloat16>(a, hd, s)
                           : launch_dot<float>(a, hd, s);
  if (e != 0) return e;
  if (route == 1) {
    return hd == 32 ? launch_bf16<32>(a, s) : launch_bf16<64>(a, s);
  }
  switch (hd) {
    case 32: return launch_f32<32>(a, s);
    case 64: return launch_f32<64>(a, s);
    case 128: return launch_f32<128>(a, s);
    default: return launch_f32<256>(a, s);
  }
}

// The wgmma kernels' dynamic shared memory and their setmaxnreg counts (the
// build report prints them beside ptxas's).
extern "C" void flash_attention_bwd_wgmma_config(int* dkdv_smem_bytes,
                                                 int* dq_smem_bytes,
                                                 int* producer_regs,
                                                 int* consumer_regs) {
  *dkdv_smem_bytes = kDkvSmem;
  *dq_smem_bytes = kDqSmem;
  *producer_regs = kWgProducerRegs;
  *consumer_regs = kWgConsumerRegs;
}

// Route 3's wgmma kernels' dynamic shared memory and threads a block (no
// setmaxnreg: every thread may take 255 registers).
extern "C" void flash_attention_bwd_hd256_config(int* dkdv_smem_bytes,
                                                 int* dq_smem_bytes,
                                                 int* threads) {
  *dkdv_smem_bytes = kH2DkvSmem;
  *dq_smem_bytes = kH2DqSmem;
  *threads = kH2Threads;
}
