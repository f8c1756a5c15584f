// Flash attention forward (online softmax) for Hopper, sm_90a.  The
// backward is csrc/flash_attention_bwd.cu; it reads the row log-sum-exp
// that this file's kernels write when asked for it.
//
//   out[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h, :] . k[b, t, kh, :])
//                     * v[b, t, kh, :],     kh = h / (H / KV)
//   lse[b, h, s]    = m + log(max(l, 1e-30))   (f32, natural log; m the row's
//                     largest scaled score, l the sum of exp(score - m))
//
// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all contiguous,
// one dtype: bf16 or f32.  hd in {32, 64, 128, 256}.  Causal: key t > query s
// is masked with -1e30 (the reference's value); with a sliding window W
// (causal only) key t <= s - W is masked too, so that each query sees the W
// keys up to its own (src/repro/models/attention.py::causal_mask).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (its `_kernel`): per (batch x head, tile of query
// rows) the KV rows stream through fast memory while a running max m, sum l
// and output acc are kept in f32; out = acc / max(l, 1e-30) in q's dtype.
// Differences from the Pallas kernel; none changes the function beyond f32
// rounding:
//   - GQA is read in place: query head h reads KV head h / (H / KV), so the
//     KV heads are never repeated H times in device memory.
//   - Ragged S and T are masked inside the kernel (rows past S are not
//     stored; keys past T weigh exactly 0), so there is no padding and no
//     shape gate.
//   - lse, when its pointer is not null, is written in each kernel's
//     epilogue from the m and l it already holds (route 0 keeps m in log2
//     units: lse = (m + log2 l) ln 2); out is the same with or without it.
//   - Under causal masking the KV tiles wholly above the diagonal are not
//     visited.  That cannot change a bit: after a live tile, a fully masked
//     one has m_new = m, so it multiplies acc and l by exp(0) = 1 and adds
//     exp(-1e30 - m) = 0.  Under a window the tiles wholly below every row's
//     window are not visited either (the loop and the producer run from key
//     tile max(0, q0 - W + 1) / tile), as the reference's chunked_attention
//     skips its kv chunks below `lo`.  A visited tile at the window's lower
//     edge may hold no key of some row's window, and may come first for it:
//     m stays -1e30 and every p of that tile is exp(0) = 1, which the row's
//     first key in its window then scales by exp(-1e30 - m) = 0, exactly as
//     the plain online softmax (and a row that no key could reach is refused
//     by the entry point: S <= T + W - 1).
//   - scale multiplies the f32 dot product (the Pallas kernel scales q
//     first; the oracle divides the product by sqrt(hd)).
//   - bf16: the tensor cores take bf16 operands, so p goes into acc += p v
//     as a hi + lo pair of bf16 (hopper::split_bf16), two products on the
//     same V tile.  That keeps p to about 2^-16 of itself, f32's precision
//     for this sum, as the Pallas kernel (which promotes v to f32) and the
//     model's chunked_attention keep it; V stays the bf16 tile it is in
//     memory.  The contract: each output row within 4e-3 of its largest
//     value of an f64 attention on the same bf16 inputs (rounding the output
//     to bf16 alone moves it by up to 2^-8 = 3.9e-3); rounding p to bf16, as
//     the oracle kernels/ref.py::flash_attention_ref does, gives 5e-3 to
//     6e-3 there.  The plain version (kernels/flash_attention.py::
//     flash_attention_plain) is this function.
//
// What bounds it on an H100: at the long-prompt shapes (S = T = 8192,
// H = 32, hd = 128; gemma-7b's H = 16, hd = 256 does the same work) a
// causal call does 4 S T hd H / 2 = 5.5e11 flop against 0.27 GB of q, k,
// v and out: 0.56 ms of bf16 tensor-core work against 0.08 ms of bytes.
// It is bound by operations, so the design goal is to keep the tensor
// cores fed.  The hi + lo split of p makes the bf16 routes
// issue 1.5 times that tensor work (Q K^T once, P V twice); the bound
// counts the function's operations, not the split's.
//
// Five routes on four kernel templates; the caller (kernels/flash_attention.py::
// flash_route) picks one from dtype and hd alone, before the launch, and
// passes it as `route`:
//
//   route 0, "wgmma" -- bf16, hd 128 (Yi-9B and every long prompt).  One
//     block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each and one producer warpgroup, of which one
//     thread issues TMA loads.  The tensor maps span the real 4-D layouts
//     (hd, heads, seq, batch), boxes of (64, 1, 128, 1), so TMA zero-fills
//     and clips at each sequence's end, never reading the next batch's
//     rows.  Q (32 KB) is loaded once; 128-key K and V tiles (32 KB each)
//     stream through a ring of two stages, each of K and V with a full and
//     an empty mbarrier, so the next tile's loads run under this one's
//     math.  S = Q K^T is wgmma m64n128k16 from shared memory (both
//     K-major, 8 steps over hd); scale (folded with log2 e, so exp2), the
//     causal / ragged mask on the tiles that need it, and the online
//     softmax run on the f32 accumulator (row max and sum over the 4 lanes
//     that share a row); p is split into a hi + lo pair of bf16 in
//     registers, and each half is the A operand of acc += P V, wgmma
//     m64n128k16 with A from registers and V read MN-major through the
//     transpose bit: two wgmma per 16 keys on one V descriptor, twice the
//     P V tensor work of a bf16 p.  p and its pairs are made a quarter
//     tile (32 keys) at a time, each quarter's exp2 and pairs while the
//     previous quarter's P V runs, in two buffers of pairs, with one drain
//     of the P V a tile (all 64 pair registers at once spilled).  acc stays
//     in registers.  setmaxnreg gives the producer 24 registers and the
//     consumers 240, the most the producer's 24 leave (at 232 the
//     consumers spilled even with a bf16 p).  Shared memory 160 KB.
//     The two consumer warpgroups run in step, and that is what an H100
//     wants here: timed per phase (clock64 marks in an instrumented copy),
//     Q K^T and P V run near the tensor-core peak with both warpgroups
//     issuing, and the softmax is issue-bound (some nine instructions an
//     element): done in one piece it would leave the tensor cores idle for
//     over a third of a tile.  Schedules that would hide more of it lost
//     on the card: a ping-pong of the two warpgroups over named
//     barriers (one warpgroup alone leaves each wait's latency exposed, so
//     its GEMM phases run at a fraction of the rate); Q K^T of the next
//     tile issued before this tile's softmax or P V (two accumulators in
//     flight, 192 registers of operands: ptxas spills and serialises the
//     wgmma, C7512), or behind its last P V quarter (serialised, C7515);
//     64-key tiles, whose operands fit (more instructions a key); Q K^T as
//     two 64-key halves; three K / V stages.  Besides the quarters, fewer
//     instructions paid: ex2.approx.ftz for p and the rescale (exp2f adds
//     three instructions an element to produce results below 2^-126, which
//     round away in every sum here), and a warp-uniform warpgroup index,
//     so that the wgmma descriptors stay in uniform registers.
//   route 3, "hd256" -- bf16, hd 256 (gemma-7b): route 0's design at twice
//     the head size.  One block owns 128 query rows of one (batch, head),
//     a warpgroup 64 of them.  Q (64 KB, four boxes of (64, 1, 128, 1))
//     is loaded once; 64-key K and V tiles (32 KB each, four boxes of
//     (64, 1, 64, 1)) stream through a ring of two stages: 193 KB of
//     shared memory.  (128-key tiles would take 256 KB.)  S = Q K^T is 16
//     wgmma m64n64k16 from shared memory (32 accumulator registers); acc
//     += P V is wgmma m64n256k16 with p's hi + lo pairs from registers
//     and V read MN-major through the transpose bit, its four 64-wide
//     boxes LBO apart: two wgmma per 16 keys into 128 accumulator
//     registers.  p and its pairs are made 16 keys at a time, each step's
//     exp2 and pairs while the previous step's P V runs, in two buffers of
//     pairs; each tile's last P V is followed in the same wgmma queue by
//     the next tile's Q K^T into a second score buffer, and a warp whose
//     rows all kept their max skips the rescale of acc (a multiply by
//     exactly 1): together 7% faster on an H100 (one A/B call), at 254
//     registers a thread (210 without the second buffer).  Registers
//     are split over an SM's four sub-partitions, a warp's from its own:
//     with a producer warpgroup (12 warps, three a sub-partition) ptxas
//     gave this kernel's consumers no more than the launch's 168 at
//     setmaxnreg 240 or 232, spilled 408 B and serialised the wgmma
//     (C7512); a single producer warp (9 warps) capped them at 168 too.
//     So the block is the two warpgroups alone (8 warps, 255 registers a
//     thread)
//     and thread 0 issues the TMA loads: Q and the first two tiles at the
//     start, then, at the end of tile j, K and V of tile j + 2 once both
//     warpgroups have read tile j's (the other warpgroup, running in
//     step, has passed that point or nearly so).
//   route 4, "hd64" -- bf16, hd 64 (hymba-1.5b): route 0's kernel
//     template (flash_wgmma_kernel<HD>) at hd 64.  Q, K and V tiles are one
//     box each, (64, 1, 128, 1) of the 4-D maps (16 KB); 128-key K and V
//     tiles stream through a ring of three stages (115,816 B of shared
//     memory).  S = Q K^T takes 4 wgmma m64n128k16 steps over hd; P V is
//     wgmma m64n64k16 (a 32-register accumulator, within the launch's 168
//     registers whatever setmaxnreg asks); a warp whose rows all kept their
//     max skips the rescale of acc (a multiply by exactly 1), as route 3
//     does.  Everything else is route 0's, whose hd-128 instantiation keeps
//     its code and bits.  The backward at hd 64 stays on route
//     1's kernels (kernels/flash_attention.py::flash_route), reading the
//     lse this route writes.  Lost on an H100 (scripts/flash_ab.py, PERF.md
//     §6, row 10w): three consumer warpgroups of 192 rows (the same time, an
//     8-byte spill); two or four stages (the same); the next tile's Q K^T
//     in a second score buffer, issued before the softmax or behind the
//     last P V (the consumers spill within 168 registers: 1.5x slower); the
//     two warpgroups alone with one thread issuing the loads and the next
//     tile's Q K^T queued behind the last P V, route 3's way (235
//     registers, no spill, 10% slower).
//   route 1, "mma_sync" -- the first version, for bf16 at hd 32 (it served
//     hd 64 too until route 4): grid (B*H, ceil(S/64)), 4 warps; each warp owns 16 query rows.
//     The q tile is staged through shared memory into mma.sync A fragments
//     held in registers for the whole kernel.  64-key tiles of K and V rows
//     stream into two shared-memory buffers by cp.async (zero-filled past
//     T), the next tile's copy in flight while this one is used.  S = q k^T
//     by mma.sync.m16n8k16 (bf16 in, f32 accumulate), its B fragments by
//     ldmatrix; scale, mask, the online softmax on the accumulator fragments
//     (row max and sum over the 4 lanes that share a row); p is split into
//     a hi + lo pair of bf16 held in registers as two A fragments of acc +=
//     p v (two mma.sync per fragment, f32 accumulate), whose B fragments
//     come from the V rows by ldmatrix.trans.  Rows of smem are padded by 8
//     bf16 so each 8-row ldmatrix phase hits 32 distinct banks.
//   route 2, "fma" -- f32: the same tiling with FMA instead of tensor cores
//     (TF32 would move f32 results by 1e-3): 256 threads as 16 x 16, each
//     thread owning 4 query rows x 4 keys of a score tile and 4 rows x
//     hd/16 columns of acc; p goes through shared memory between the two
//     products.
//   route 2 at hd 256 is the same template at 219 KB of shared memory.
//   Query tiles are issued last-first so the causal tiles with the most
//   keys start first.  Under a window every query tile past the first W
//   keys visits about W / tile + 1 key tiles, so the order no longer
//   matters there; the first tiles, which visit fewer, still go last.
//   Routes 1 and 2 use expf, routes 0 and 3 ex2.approx.ftz of
//   the log2-scaled scores (exp2f's own instruction, less its handling of
//   results below 2^-126, which it flushes to 0); no fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask value

// ---------------------------------------------------------------------------
// route 1, bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;             // query rows per block (16 per warp)
constexpr int kBKV = 64;            // keys per tile
constexpr int kPad = 8;             // bf16 of padding per shared-memory row
constexpr int kThreadsMma = 128;

using hopper::split_bf16;

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

// The q tile is staged in K buffer 1 and held in registers as A fragments.
template <int HD>
struct MmaSmem {
  static constexpr int LD = HD + kPad;            // bf16 per smem row
  static constexpr int kTile = kBKV * LD;         // one K or V tile
  static constexpr int kBytes = 4 * kTile * 2;    // K and V, double-buffered
};

// The first key tile of size `tile` that a query tile starting at q0 can
// see: under a causal window W (W > 0) the key q0 - W + 1, else key 0.
__device__ __forceinline__ int first_tile(int q0, int causal, int window,
                                          int tile) {
  return causal && window > 0 ? max(0, q0 - window + 1) / tile : 0;
}

// How far below its query a key may lie and still be seen: W keys including
// the query's own are kept (key > qpos - W), so a key is masked where key +
// span <= qpos.  Without a window the span is 2^30, which no position reaches.
__device__ __forceinline__ int window_span(int causal, int window) {
  return causal && window > 0 ? window : (1 << 30);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsMma)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int S, int T, int H, int KV, float scale, int causal,
                  int window) {
  using SM = MmaSmem<HD>;
  constexpr int LD = SM::LD;
  constexpr int NT = kBKV / 8;        // n-tiles of the score tile
  constexpr int KD = HD / 16;         // k-steps over the head dim
  constexpr int DT = HD / 8;          // n-tiles of the output
  constexpr int CH = HD / 8;          // 16-byte chunks per row
  static_assert(kBQ == kBKV, "the q tile is staged in a K buffer");
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  // buffers: K0, V0, K1, V1, each kBKV rows of LD
  auto kbuf = [&](int i) { return smem_bf16 + (2 * i) * SM::kTile; };
  auto vbuf = [&](int i) { return smem_bf16 + (2 * i + 1) * SM::kTile; };
  __nv_bfloat16* qs = kbuf(1);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = static_cast<size_t>(H) * HD;    // between tokens
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * S * q_stride +
                            static_cast<size_t>(h) * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * T * kv_stride +
                            static_cast<size_t>(kh) * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * T * kv_stride +
                            static_cast<size_t>(kh) * HD;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * S * q_stride +
                      static_cast<size_t>(h) * HD;

  // one tile of K and V rows j0.. into buffer `buf` (zeros past T)
  auto load_kv = [&](int j0, int buf) {
    __nv_bfloat16* ks = kbuf(buf);
    __nv_bfloat16* vs = vbuf(buf);
    for (int i = tid; i < kBKV * CH; i += kThreadsMma) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = j0 + r < T;
      const size_t off = in ? (j0 + r) * kv_stride + c : 0;
      cp_async16(ks + r * LD + c, kb + off, in);
      cp_async16(vs + r * LD + c, vb + off, in);
    }
    cp_async_commit();
  };

  // key tiles lo .. n_tiles - 1: those below a causal window's lower edge
  // and those above the diagonal are not visited
  const int lo = first_tile(q0, causal, window, kBKV);
  const int span = window_span(causal, window);
  int n_tiles = (T + kBKV - 1) / kBKV;
  if (causal) {
    const int last_q = min(q0 + kBQ, S) - 1;
    n_tiles = min(n_tiles, last_q / kBKV + 1);
  }

  // q tile -> its buffer (zeros past S), while tile lo streams into buffer 0
  for (int i = tid; i < kBQ * CH; i += kThreadsMma) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < S;
    cp_async16(qs + r * LD + c, qb + (in ? (q0 + r) * q_stride + c : 0), in);
  }
  cp_async_commit();
  load_kv(lo * kBKV, 0);
  cp_async_wait<1>();                 // the q tile has landed
  __syncthreads();
  // A fragments of rows warp*16 .. +15: matrix i of ldmatrix.x4 is rows
  // (i & 1) * 8 .., columns (i >> 1) * 8 .. of each 16 x 16 block
  const int q_row = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qf[kk], qs + q_row * LD + kk * 16 + (lane >> 4) * 8);
  }
  __syncthreads();                    // buffer 1 is free for tile lo + 1

  // this thread's two query rows: row0 (c0, c1) and row0 + 8 (c2, c3)
  const int qpos0 = q0 + warp * 16 + g, qpos1 = qpos0 + 8;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  }

  for (int jt = lo; jt < n_tiles; ++jt) {
    const int j0 = jt * kBKV;
    const int buf = (jt - lo) & 1;
    if (jt + 1 < n_tiles) {
      load_kv(j0 + kBKV, buf ^ 1);
      cp_async_wait<1>();             // tile jt has landed, jt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kbuf(buf);
    const __nv_bfloat16* vs = vbuf(buf);

    // scores for 16 rows x 64 keys: s[nt][0..1] row0, s[nt][2..3] row0 + 8.
    // ldmatrix.x4 on K rows nt*8 .. +7 gives b0, b1 of two k-steps.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int kk = 0; kk < KD; kk += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, ks + (nt * 8 + (lane & 7)) * LD + kk * 16 +
                        (lane >> 3) * 8);
        mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
        mma_bf16(s[nt], qf[kk + 1], kf[2], kf[3]);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + nt * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        float x = s[nt][e] * scale;
        // the window's test apart from the diagonal's: one condition of
        // both spilled at hd 32
        if (key >= T) {
          x = -INFINITY;                  // absent: weighs exactly 0
        } else if (causal && key > qpos) {
          x = kNegInf;
        } else if (key + span <= qpos) {
          x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      corr[rr] = expf(m[rr] - mx[rr]);
      m[rr] = mx[rr];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l[rr] = l[rr] * corr[rr] + sum[rr];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }
    // acc += p v: two score n-tiles form one A fragment over 16 keys, as a
    // hi + lo pair of bf16 fragments; the B fragments come from V rows
    // (keys) by ldmatrix.trans, two dim tiles per x4
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LD + (d + (lane >> 4)) * 8);
        mma_bf16(acc[d], ph, vf[0], vf[1]);
        mma_bf16(acc[d], pl, vf[0], vf[1]);
        mma_bf16(acc[d + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[d + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                  // buffer jt & 1 is free for jt + 2
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = rr ? qpos1 : qpos0;
    if (qpos >= S) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    if (lse != nullptr && t == 0) {
      lse[static_cast<size_t>(bh) * S + qpos] = m[rr] + logf(den);
    }
    __nv_bfloat16* orow = ob + qpos * q_stride;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * rr] / den, acc[d][2 * rr + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// routes 0 (bf16, hd 128) and 4 (bf16, hd 64): TMA, an mbarrier ring,
// wgmma, a producer warpgroup; one template on HD
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;            // query rows per block, 64 a consumer
constexpr int kWgKeys = 128;            // keys per K / V tile
constexpr int kWgThreads = 384;         // consumers: warpgroups 0, 1; producer: 2
constexpr int kWgProducerRegs = 24;   // setmaxnreg, per thread
constexpr int kWgConsumerRegs = 240;   // (24 + 2 x 240) x 128 = 168 x 384
constexpr int kWgBox = 128 * 64 * 2;    // one TMA box: 128 rows x 64 bf16
// a 128-row Q, K or V tile: HD / 64 boxes
template <int HD> constexpr int kWgTile = HD / 64 * kWgBox;
// the K / V ring: two stages at hd 128, three at hd 64
template <int HD> constexpr int kWgStages = HD == 64 ? 3 : 2;
template <int HD> constexpr int kWgBars = 1 + 4 * kWgStages<HD>;
// Q, then per stage K and V; barriers after; 1 KB of slack to align the base
template <int HD>
constexpr int kWgSmem =
    1024 + kWgTile<HD> * (1 + 2 * kWgStages<HD>) + 8 * kWgBars<HD>;

// 2^x by the special-function unit, a result below 2^-126 flushed to 0:
// the instruction exp2f issues, without the three that exp2f adds to
// produce those results as subnormals
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int S, int T, int H, int KV, float scale_log2, int causal,
                   int window) {
  using namespace hopper;
  constexpr int kTile = kWgTile<HD>, kStages = kWgStages<HD>;
  constexpr int kBoxes = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                                     // box c: hd 64c..
  auto ks = [&](int s) { return base + kTile * (1 + 2 * s); };
  auto vs = [&](int s) { return base + kTile * (2 + 2 * s); };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + kTile * (1 + 2 * kStages));
  uint64_t* k_full = q_full + 1;                          // [kStages] each
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  // key tiles lo .. n_tiles - 1, the ring's stages counted from lo
  const int lo = first_tile(q0, causal, window, kWgKeys);
  const int span = window_span(causal, window);
  int n_tiles = (T + kWgKeys - 1) / kWgKeys;
  if (causal) {
    n_tiles = min(n_tiles, (min(q0 + kWgRows, S) - 1) / kWgKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);             // the producer's expect_tx
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);            // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform to the compiler (a broadcast from lane 0), so that the
  // wgmma descriptors derived from it are computed in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // producer: one thread issues every load; the rest of the warpgroup
    // only hands back its registers
    setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, kTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_4d(qs + c * kWgBox, &tm_q, q_full, 64 * c, h, q0, b);
      }
      for (int jt = lo; jt < n_tiles; ++jt) {
        const int s = (jt - lo) % kStages;
        const uint32_t ph = ((jt - lo) / kStages) & 1;
        const int j0 = jt * kWgKeys;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&k_full[s], kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(ks(s) + c * kWgBox, &tm_k, &k_full[s], 64 * c, kh, j0,
                      b);
        }
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&v_full[s], kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_4d(vs(s) + c * kWgBox, &tm_v, &v_full[s], 64 * c, kh, j0,
                      b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows row0 .. row0 + 63
    setmaxnreg_inc<kWgConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + wg * 64;
    const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
    const uint32_t q_addr = smem_addr(qs) + wg * 64 * 128;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};            // this thread's part of each row sum

    mbar_wait(q_full, 0);
    for (int jt = lo; jt < n_tiles; ++jt) {
      const int s = (jt - lo) % kStages;
      const uint32_t ph = ((jt - lo) / kStages) & 1;
      const int j0 = jt * kWgKeys;

      // scores: sc[4 j + e] is row r_lo (e < 2) or r_hi, key j0 + 8 j + 2 t
      // + (e & 1); HD / 16 k16 steps, 32 bytes apart in a box
      float sc[64];
      mbar_wait(&k_full[s], ph);
      const uint32_t k_addr = smem_addr(ks(s));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kWgBox + (kk % 4) * 32;
        wgmma_m64n128k16_ss(sc, desc_sw128(q_addr + off, 16, 1024),
                               desc_sw128(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[s]);

#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      // the ragged end, the diagonal and a window's lower edge: masked on
      // the tiles that cross them.  A row may see no key of a tile at the
      // window's edge; with every score at -1e30 its m stays -1e30 and its p
      // are 1, and the first key in its window rescales l and acc by
      // exp2(-1e30 - m) = 0, as the plain online softmax does.
      if (j0 + kWgKeys > T || (causal && j0 + kWgKeys - 1 > row0) ||
          j0 + span <= row0 + 63) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = j0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int qpos = (i & 2) ? r_hi : r_lo;
          if (key >= T) {
            sc[i] = -INFINITY;            // absent: weighs exactly 0
          } else if (causal && (key > qpos || key + span <= qpos)) {
            sc[i] = kNegInf;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        corr[rr] = ex2_ftz(m[rr] - mx[rr]);
        m[rr] = mx[rr];
        l[rr] *= corr[rr];
      }
      // at hd 64 a warp whose rows all kept their max (corr 1) skips the
      // rescale, which would multiply by exactly 1; hd 128 rescales always
      if (HD == 128 ||
          __any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      // p = exp2(s - m) and its hi + lo pairs of bf16 A operands, a quarter
      // tile (32 keys, accumulator chunks 8 q .. 8 q + 7) at a time: keys
      // 16 kk .. 16 kk + 15 are the chunks 2 kk and 2 kk + 1.  Quarter qt's
      // exp2 and pairs are computed while the P V of quarter qt - 1 runs;
      // two buffers of pairs, each free again once the quarter two back
      // has been waited for.  l sums p in the order of i, as before.  P V
      // is wgmma m64nHDk16 with V read MN-major through the transpose bit,
      // a k16 step 16 key rows (2 KB) apart.
      const uint32_t v_addr = smem_addr(vs(s));
      uint32_t p_hi[2][2][4], p_lo[2][2][4];
#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
#pragma unroll
        for (int i = 16 * qt; i < 16 * qt + 16; ++i) {
          const int rr = (i >> 1) & 1;
          sc[i] = ex2_ftz(sc[i] - m[rr]);
          l[rr] += sc[i];
        }
        if (qt >= 2) wgmma_wait<1>();     // quarter qt - 2 has read its pairs
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * (2 * qt + kk) + 2 * e;
            split_bf16(sc[i], sc[i + 1], p_hi[qt & 1][kk][e],
                       p_lo[qt & 1][kk][e]);
          }
        }
        if (qt == 0) mbar_wait(&v_full[s], ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t v_desc =
              desc_sw128(v_addr + (2 * qt + kk) * 2048, kWgBox, 1024);
          if constexpr (HD == 128) {
            wgmma_m64n128k16_rs(o, p_hi[qt & 1][kk], v_desc, 1);
            wgmma_m64n128k16_rs(o, p_lo[qt & 1][kk], v_desc, 1);
          } else {
            wgmma_m64n64k16_rs(o, p_hi[qt & 1][kk], v_desc, 1);
            wgmma_m64n64k16_rs(o, p_lo[qt & 1][kk], v_desc, 1);
          }
        }
        wgmma_commit();
        // the next quarter's exp2 reads sc after this issue, not before it
        fence_regs(sc);
      }
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[s]);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = rr ? r_hi : r_lo;
      if (qpos >= S) continue;
      const float den = fmaxf(l[rr], 1e-30f);
      if (lse != nullptr && t == 0) {
        // m and the scores are in log2 units (scale_log2)
        lse[static_cast<size_t>(bh) * S + qpos] =
            (m[rr] + log2f(den)) * 0.69314718055994531f;
      }
      __nv_bfloat16* orow = out + (static_cast<size_t>(b) * S + qpos) * H * HD +
                            static_cast<size_t>(h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * rr] / den,
                                  o[4 * j + 2 * rr + 1] / den);
      }
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int T, int H, int KV, int causal,
                 float scale, int window, cudaStream_t stream) {
  // 4-D maps over (hd, heads, seq, batch), HD of 2 bytes
  CUtensorMap tq, tk, tv;
  constexpr uint64_t kRow = 2 * HD;       // bytes of one head's row
  const uint64_t qdim[4] = {HD, static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t qstr[3] = {kRow, kRow * H, kRow * H * S};
  const uint64_t kdim[4] = {HD, static_cast<uint64_t>(KV),
                            static_cast<uint64_t>(T), static_cast<uint64_t>(B)};
  const uint64_t kstr[3] = {kRow, kRow * KV, kRow * KV * T};
  const uint32_t box[4] = {64, 1, kWgRows, 1};
  int err = hopper::make_tensor_map_bf16(&tq, q, 4, qdim, qstr, box);
  if (err == 0) err = hopper::make_tensor_map_bf16(&tk, k, 4, kdim, kstr, box);
  if (err == 0) err = hopper::make_tensor_map_bf16(&tv, v, 4, kdim, kstr, box);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmem<HD>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + kWgRows - 1) / kWgRows);
  flash_wgmma_kernel<HD><<<grid, kWgThreads, kWgSmem<HD>, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, T, H, KV,
      scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route 3, bf16, hd 256: route 0's design with 64-key tiles, m64n256 P V
// and thread 0 as the producer
// ---------------------------------------------------------------------------

constexpr int kH2Rows = 128;              // query rows a block, 64 a warpgroup
constexpr int kH2Keys = 64;               // keys per K / V tile
constexpr int kH2Stages = 2;              // K / V ring
// two warpgroups, no producer warp: each SM sub-partition then holds two
// warps, which may take 255 registers a thread (the kernel uses 254); a
// third warp there, as a producer's, caps every thread at 168
constexpr int kH2Threads = 256;
constexpr int kH2QBox = 128 * 128;        // one Q box: 128 rows x 64 bf16
constexpr int kH2KBox = 64 * 128;         // one K or V box: 64 rows x 64 bf16
constexpr int kH2Q = 4 * kH2QBox;         // Q, 128 x 256 bf16 (64 KB)
constexpr int kH2Tile = 4 * kH2KBox;      // a 64 x 256 K or V tile (32 KB)
constexpr int kH2Bars = 1 + 4 * kH2Stages;
// Q, then per stage K and V; barriers after; 1 KB of slack to align the base
constexpr int kH2Smem = 1024 + kH2Q + 2 * kH2Stages * kH2Tile + 8 * kH2Bars;

__global__ void __launch_bounds__(kH2Threads, 1)
flash_wgmma_hd256_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int S, int T, int H, int KV,
                         float scale_log2, int causal, int window) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                                     // box c: hd 64c..
  auto ks = [&](int s) { return base + kH2Q + kH2Tile * (2 * s); };
  auto vs = [&](int s) { return base + kH2Q + kH2Tile * (2 * s + 1); };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + kH2Q + 2 * kH2Stages * kH2Tile);
  uint64_t* k_full = q_full + 1;                          // [kH2Stages] each
  uint64_t* v_full = k_full + kH2Stages;
  uint64_t* k_empty = v_full + kH2Stages;
  uint64_t* v_empty = k_empty + kH2Stages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kH2Rows;
  // key tiles lo .. n_tiles - 1, the ring's stages counted from lo
  const int lo = first_tile(q0, causal, window, kH2Keys);
  const int span = window_span(causal, window);
  int n_tiles = (T + kH2Keys - 1) / kH2Keys;
  if (causal) {
    n_tiles = min(n_tiles, (min(q0 + kH2Rows, S) - 1) / kH2Keys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kH2Stages; ++s) {
      mbar_init(&k_full[s], 1);             // thread 0's expect_tx
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);            // one arrival per warp
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 issues every load: Q and the first two tiles now; then, at
  // the end of tile jt, K and V of tile jt + 2 once both warpgroups have
  // read tile jt's
  auto load_k = [&](int jt) {
    const int s = (jt - lo) % kH2Stages;
    mbar_arrive_expect_tx(&k_full[s], kH2Tile);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(ks(s) + c * kH2KBox, &tm_k, &k_full[s], 64 * c, kh,
                  jt * kH2Keys, b);
    }
  };
  auto load_v = [&](int jt) {
    const int s = (jt - lo) % kH2Stages;
    mbar_arrive_expect_tx(&v_full[s], kH2Tile);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(vs(s) + c * kH2KBox, &tm_v, &v_full[s], 64 * c, kh,
                  jt * kH2Keys, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_full, kH2Q);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(qs + c * kH2QBox, &tm_q, q_full, 64 * c, h, q0, b);
    }
    for (int jt = lo; jt < min(lo + kH2Stages, n_tiles); ++jt) {
      load_k(jt);
      load_v(jt);
    }
  }

  // warpgroup wg: query rows row0 .. row0 + 63.  Warp-uniform to the
  // compiler (a broadcast from lane 0), so that the wgmma descriptors
  // derived from it are computed in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + wg * 64;
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  const uint32_t q_addr = smem_addr(qs) + wg * 64 * 128;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};            // this thread's part of each row sum

  mbar_wait(q_full, 0);
  // S = Q K^T of tile jt into acc (sc[4 j + e] is row r_lo (e < 2) or
  // r_hi, key 64 jt + 8 j + 2 t + (e & 1)): 16 k16 steps over hd, four of
  // each 64-wide box, committed as one group
  auto qk = [&](float (&acc)[32], int jt) {
    const int s = (jt - lo) % kH2Stages;
    mbar_wait(&k_full[s], ((jt - lo) / kH2Stages) & 1);
    const uint32_t k_addr = smem_addr(ks(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_m64n64k16_ss(
          acc, desc_sw128(q_addr + (kk / 4) * kH2QBox + off, 16, 1024),
          desc_sw128(k_addr + (kk / 4) * kH2KBox + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  float sc[32];
  qk(sc, lo);
  wgmma_wait<0>();
  fence_regs(sc);
  __syncwarp();
  if (lane == 0) mbar_arrive(&k_empty[0]);
  for (int jt = lo; jt < n_tiles; ++jt) {
    const int s = (jt - lo) % kH2Stages;
    const uint32_t ph = ((jt - lo) / kH2Stages) & 1;
    const int j0 = jt * kH2Keys;

#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    // the ragged end, the diagonal and a window's lower edge, as route 0
    if (j0 + kH2Keys > T || (causal && j0 + kH2Keys - 1 > row0) ||
        j0 + span <= row0 + 63) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = j0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int qpos = (i & 2) ? r_hi : r_lo;
        if (key >= T) {
          sc[i] = -INFINITY;            // absent: weighs exactly 0
        } else if (causal && (key > qpos || key + span <= qpos)) {
          sc[i] = kNegInf;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      corr[rr] = ex2_ftz(m[rr] - mx[rr]);
      m[rr] = mx[rr];
      l[rr] *= corr[rr];
    }
    // a warp whose rows all kept their max (corr 1) skips the rescale,
    // which would multiply by exactly 1
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    // p = exp2(s - m) and its hi + lo pairs, 16 keys (accumulator chunks
    // 2 kk and 2 kk + 1) at a time, each step's exp2 and pairs while the
    // previous step's P V runs; two buffers of pairs, each free again
    // once the step two back has been waited for
    const uint32_t v_addr = smem_addr(vs(s));
    uint32_t p_hi[2][4], p_lo[2][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
        const int rr = (i >> 1) & 1;
        sc[i] = ex2_ftz(sc[i] - m[rr]);
        l[rr] += sc[i];
      }
      if (kk >= 2) wgmma_wait<1>();     // step kk - 2 has read its pairs
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                   p_hi[kk & 1][e], p_lo[kk & 1][e]);
      }
      if (kk == 0) mbar_wait(&v_full[s], ph);
      wgmma_fence();
      // keys 16 kk .. + 15 of the four 64-wide hd boxes, kH2KBox apart
      const uint64_t v_desc =
          desc_sw128(v_addr + kk * 2048, kH2KBox, 1024);
      wgmma_m64n256k16_rs(o, p_hi[kk & 1], v_desc, 1);
      wgmma_m64n256k16_rs(o, p_lo[kk & 1], v_desc, 1);
      wgmma_commit();
      // the next step's exp2 reads sc after this issue, not before it
      fence_regs(sc);
    }
    // the next tile's Q K^T queued behind this tile's last P V, so the
    // tensor cores go on to it without waiting for this warpgroup
    float sn[32];
    if (jt + 1 < n_tiles) qk(sn, jt + 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(sn);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&v_empty[s]);
      if (jt + 1 < n_tiles) mbar_arrive(&k_empty[s ^ 1]);
    }
    if (threadIdx.x == 0 && jt + 2 < n_tiles) {
      // K and V of tile jt read by both warpgroups: tile jt + 2's
      mbar_wait(&k_empty[s], ph);
      load_k(jt + 2);
      mbar_wait(&v_empty[s], ph);
      load_v(jt + 2);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = sn[i];
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = rr ? r_hi : r_lo;
    if (qpos >= S) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    if (lse != nullptr && t == 0) {
      // m and the scores are in log2 units (scale_log2)
      lse[static_cast<size_t>(bh) * S + qpos] =
          (m[rr] + log2f(den)) * 0.69314718055994531f;
    }
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * S + qpos) * H * 256 +
                          static_cast<size_t>(h) * 256;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * rr] / den,
                                o[4 * j + 2 * rr + 1] / den);
    }
  }
}

int launch_hd256(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int T, int H, int KV, int causal,
                 float scale, int window, cudaStream_t stream) {
  // 4-D maps over (hd, heads, seq, batch), 256 hd of 2 bytes; Q in boxes of
  // 128 rows, K and V of 64
  CUtensorMap tq, tk, tv;
  const uint64_t qdim[4] = {256, static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t qstr[3] = {512, 512ull * H, 512ull * H * S};
  const uint64_t kdim[4] = {256, static_cast<uint64_t>(KV),
                            static_cast<uint64_t>(T), static_cast<uint64_t>(B)};
  const uint64_t kstr[3] = {512, 512ull * KV, 512ull * KV * T};
  const uint32_t qbox[4] = {64, 1, kH2Rows, 1};
  const uint32_t kbox[4] = {64, 1, kH2Keys, 1};
  int err = hopper::make_tensor_map_bf16(&tq, q, 4, qdim, qstr, qbox);
  if (err == 0) err = hopper::make_tensor_map_bf16(&tk, k, 4, kdim, kstr, kbox);
  if (err == 0) err = hopper::make_tensor_map_bf16(&tv, v, 4, kdim, kstr, kbox);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_hd256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kH2Smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + kH2Rows - 1) / kH2Rows);
  flash_wgmma_hd256_kernel<<<grid, kH2Threads, kH2Smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, T, H, KV,
      scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route 2, f32: FMA
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;    // 16 x 16

template <int HD>
struct F32Smem {
  static constexpr int LDQ = kBQ + 1;     // q and k stored transposed
  static constexpr int LDP = kBKV + 16;   // p rows: even/odd rows 16 banks apart
  static constexpr int kFloats = HD * LDQ * 2 + kBKV * HD + kBQ * LDP;
  static constexpr int kBytes = kFloats * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int T, int H, int KV,
                 float scale, int causal, int window) {
  using SM = F32Smem<HD>;
  constexpr int LDQ = SM::LDQ, LDP = SM::LDP;
  constexpr int DC = HD / 16;             // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                       // [HD][LDQ]: q tile transposed
  float* kt = qt + HD * LDQ;              // [HD][LDQ]: k tile transposed
  float* vs = kt + HD * LDQ;              // [kBKV][HD]
  float* ps = vs + kBKV * HD;             // [kBQ][LDP]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const float* qb = q + static_cast<size_t>(b) * S * q_stride +
                    static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * T * kv_stride +
                    static_cast<size_t>(kh) * HD;
  const float* vb = v + static_cast<size_t>(b) * T * kv_stride +
                    static_cast<size_t>(kh) * HD;
  float* ob = out + static_cast<size_t>(b) * S * q_stride +
              static_cast<size_t>(h) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreadsF32) {
    const int r = i / HD, c = i % HD;
    qt[c * LDQ + r] = q0 + r < S ? qb[(q0 + r) * q_stride + c] : 0.0f;
  }

  // rows ty + 16 i (i < 4); score columns tx + 16 j (j < 4); output
  // columns tx + 16 c (c < DC)
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int lo = first_tile(q0, causal, window, kBKV);
  const int span = window_span(causal, window);
  int n_tiles = (T + kBKV - 1) / kBKV;
  if (causal) {
    const int last_q = min(q0 + kBQ, S) - 1;
    n_tiles = min(n_tiles, last_q / kBKV + 1);
  }
  for (int jt = lo; jt < n_tiles; ++jt) {
    const int j0 = jt * kBKV;
    for (int i = tid; i < kBKV * HD; i += kThreadsF32) {
      const int r = i / HD, c = i % HD;
      const bool in = j0 + r < T;
      kt[c * LDQ + r] = in ? kb[(j0 + r) * kv_stride + c] : 0.0f;
      vs[r * HD + c] = in ? vb[(j0 + r) * kv_stride + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[d * LDQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * LDQ + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (key >= T) {
          x = -INFINITY;
        } else if (causal && (key > qpos || key + span <= qpos)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) {
      lse[static_cast<size_t>(bh) * S + qpos] = m[i] + logf(den);
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      ob[qpos * q_stride + tx + 16 * c] = acc[i][c] / den;
    }
  }
}

// route 1: bf16, hd 32
template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int T, int H, int KV, int causal,
               float scale, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  constexpr int bytes = MmaSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bf16_kernel<HD><<<grid, kThreadsMma, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, S, T, H, KV, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

// route 2: f32, hd 32, 64, 128 or 256
template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int T, int H, int KV, int causal,
               float scale, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  constexpr int bytes = F32Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_kernel<HD><<<grid, kThreadsF32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, T, H,
      KV, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks devices, dtypes and contiguity, and that the pointers are
// 16-byte aligned; B, S, T, H >= 1 and H % KV == 0.  dtype 0 = bf16, 1 =
// f32.  route 0 = wgmma (bf16, hd 128), 1 = mma_sync (bf16, hd 32),
// 2 = fma (f32, hd 32, 64, 128 or 256), 3 = hd256 (bf16, hd 256), 4 = hd64
// (bf16, hd 64); a route
// that the dtype and hd do not select is refused.  lse: null, or f32 (B, H,
// S) to receive each row's log-sum-exp.  window: 0 for none, else W >= 1
// keys including the query's own under causal masking (key > query - W),
// with S <= T + W - 1 so that every row sees a key.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse_, int B, int S, int T,
                                   int H, int KV, int hd, int dtype,
                                   int causal, float scale, int route,
                                   int window, void* stream) {
  float* lse = static_cast<float*>(lse_);
  const bool fits =
      (route == 0 && dtype == 0 && hd == 128) ||
      (route == 1 && dtype == 0 && hd == 32) ||
      (route == 2 && dtype == 1 &&
       (hd == 32 || hd == 64 || hd == 128 || hd == 256)) ||
      (route == 3 && dtype == 0 && hd == 256) ||
      (route == 4 && dtype == 0 && hd == 64);
  const bool window_ok =
      window == 0 || (window > 0 && causal &&
                      static_cast<long long>(S) <=
                          static_cast<long long>(T) + window - 1);
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      !fits || !window_ok || (S + kBQ - 1) / kBQ > 65535 ||
      static_cast<long long>(B) * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0 || route == 4) {
    return (route == 0 ? launch_wgmma<128> : launch_wgmma<64>)(
        q, k, v, out, lse, B, S, T, H, KV, causal, scale, window, s);
  }
  if (route == 3) {
    return launch_hd256(q, k, v, out, lse, B, S, T, H, KV, causal, scale,
                        window, s);
  }
  if (route == 1) {
    return launch_mma<32>(q, k, v, out, lse, B, S, T, H, KV, causal, scale,
                          window, s);
  }
  switch (hd) {
    case 32:
      return launch_fma<32>(q, k, v, out, lse, B, S, T, H, KV, causal, scale,
                            window, s);
    case 64:
      return launch_fma<64>(q, k, v, out, lse, B, S, T, H, KV, causal, scale,
                            window, s);
    case 128:
      return launch_fma<128>(q, k, v, out, lse, B, S, T, H, KV, causal, scale,
                             window, s);
    default:
      return launch_fma<256>(q, k, v, out, lse, B, S, T, H, KV, causal, scale,
                             window, s);
  }
}

// The wgmma kernel's (route 0) dynamic shared memory and its setmaxnreg
// counts (the build report prints them beside ptxas's).
extern "C" void flash_attention_wgmma_config(int* smem_bytes, int* producer_regs,
                                    int* consumer_regs) {
  *smem_bytes = kWgSmem<128>;
  *producer_regs = kWgProducerRegs;
  *consumer_regs = kWgConsumerRegs;
}

// The hd-256 wgmma kernel's (route 3) dynamic shared memory and threads; it
// sets no register counts.
extern "C" void flash_attention_hd256_config(int* smem_bytes, int* threads) {
  *smem_bytes = kH2Smem;
  *threads = kH2Threads;
}

// The hd-64 wgmma kernel's (route 4) dynamic shared memory and its
// setmaxnreg counts (the build report prints them beside ptxas's).
extern "C" void flash_attention_hd64_config(int* smem_bytes,
                                            int* producer_regs,
                                            int* consumer_regs) {
  *smem_bytes = kWgSmem<64>;
  *producer_regs = kWgProducerRegs;
  *consumer_regs = kWgConsumerRegs;
}
