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
// GroupedLoraKernel in that file).  Any M, K, N; ragged edges are masked
// (the Pallas version zero-pads N instead).  Ranks up to 64.  A page index
// outside [0, G) is clamped, so a bad index cannot read outside the pool.
//
// What bounds it on an H100: at the serving decode shapes (M = lanes = 8,
// K = 4096, R = 16, N in {4096, 512}, G = pages = 4) one launch must move
// x, the used a and b pages and the output, about 1.2-2 MB: 0.4-0.6 us at
// 3.35 TB/s, and ~2 MFLOP, far below the f32 rate.  A launch this small is
// bound by latency: the launch itself (an empty launch of the same grid
// takes 1.7-2.0 us on the card, back to back), one round trip for gidx,
// one for the pages, the exchange between the blocks of a cluster and the
// store.  Decode launches it 4 times per layer (wq, wk, wv, wo), 192 times
// a step for a 48-layer model.
//
// Design: one launch per call, one thread-block cluster of kCluster = 8
// blocks (256 threads each) per (page g, chunk of up to RC of the rows that
// use g; RC = 64 at R <= 16, 32 at R <= 32, 16 above).  Grid (8, G,
// ceil(M / RC)).  Block c of a cluster owns the K / 8 slice k0..k1 of a[g]
// and the N / 8 slice n0..n1 of b[g] and out.
//   1. Rows: every block scans gidx and keeps the rows of page g whose rank
//      among g's rows falls in its chunk, in row order.  A chunk with no
//      rows (an unused page, or past the page's last row) exits at once,
//      the whole cluster alike, before reading the page.
//   2. The expand's b values: where one pass of the expand does (R <= 16,
//      at most 8 rows, N <= 8192), each thread loads its four columns of
//      b[g, :, slice] into registers now, so that they arrive under steps 3
//      and 4.
//   3. Shrink: block c reduces its slice of a[g] against the rows' x into
//      an f32 partial xa (part) in shared memory.  64 k-lanes x 4
//      rank-lanes, each thread taking quads of 4 consecutive k (16-byte
//      loads of x and of a) and groups of 4 ranks; two quads of loads in
//      flight at once.  Warp shuffles, then the 8 warps in order.  The
//      split of k over threads is the same at every rank, so a zero-padded
//      rank gives the same bits.
//   4. Exchange: each block writes its partial into every block's inbox
//      (st.async, 16 bytes a write, completing its bytes on the receiver's
//      mbarrier); each block waits on its own mbarrier and sums the 8
//      partials in rank order, so xa[m, :] is computed once per row and
//      every block of the cluster holds the same bits.  A block leaves only
//      after its inbox has filled, so no peer writes into a block that has
//      left, and no cluster barrier follows the exchange.
//   5. Expand: block c writes its N / 8 slice of out for all its rows, scale
//      last (16-byte stores).
// So xa is computed once per row, each used page's a and b bytes are read
// once per launch (once per chunk of RC of its rows), and no float atomics
// are used: every sum has a fixed order, and two launches on the same
// inputs give the same bits.  16-byte loads and stores need K, R and N to
// be multiples of 4 and every pointer 16-byte aligned (a compile-time
// variant); otherwise every operand moves element by element.  Loads are
// branch-free (a masked element reads a valid address and is then
// replaced by 0), so the loads of a batch are in flight together (a branch
// around each load serialised them).
// At the decode shapes 4 clusters of 8 blocks run, each block moving
// 32 KB of a and, at N = 4096, 32 KB of b.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;            // blocks per cluster: the K and N slices
constexpr int kRowsPerCluster = 64;    // rows of one page per cluster (R <= 16)
constexpr int kRowTile = 8;            // rows per register tile (at most)
constexpr int kRankLanes = 4;          // shrink: threads along the rank
constexpr int kKLanes = kThreads / kRankLanes;   // ... and along k

// p[i .. i + 3], each element at or past `end` as 0 (end >= 1), without a
// branch: a masked element reads a valid address and is then replaced, so
// every load of a loop body can be in flight at once.  VEC: one 16-byte
// load; the caller guarantees 16-byte alignment, end % 4 == 0 and i % 4 ==
// 0 (so the four are all in range or all out).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int i, int end) {
  if constexpr (VEC) {
    const bool in = i < end;
    const float4 v = *reinterpret_cast<const float4*>(p + (in ? i : end - 4));
    return in ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    const float v0 = p[min(i, end - 1)], v1 = p[min(i + 1, end - 1)];
    const float v2 = p[min(i + 2, end - 1)], v3 = p[min(i + 3, end - 1)];
    return make_float4(i < end ? v0 : 0.0f, i + 1 < end ? v1 : 0.0f,
                       i + 2 < end ? v2 : 0.0f, i + 3 < end ? v3 : 0.0f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int i, int end, float4 v) {
  if constexpr (VEC) {
    if (i < end) *reinterpret_cast<float4*>(p + i) = v;
  } else {
    if (i < end) p[i] = v.x;
    if (i + 1 < end) p[i + 1] = v.y;
    if (i + 2 < end) p[i + 2] = v.z;
    if (i + 3 < end) p[i + 3] = v.w;
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float w, float4 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

// Step 3 for rows t0 .. t0 + TR - 1 (those below nrows): part[t0 + i, r] =
// sum_{k0 <= k < k1} x[rows[t0 + i], k] a[g, k, r].  Thread (kl, rl) of 64
// k-lanes x 4 rank-lanes takes the quads k = k0 + 4 kl + 256 j .. + 3 (one
// 16-byte load of x per row and quad) and the ranks 4 rg .. + 3 of rg = rl,
// rl + 4, ....  The order of every sum over k is the same for every RP, so
// zero-padding the rank changes no bit.  `red` holds the warps' partials
// (kWarps * TR rows).
template <int RP, bool VEC, int TR>
__device__ __forceinline__ void shrink_tile(const float* __restrict__ x,
                                            const float* __restrict__ ag,
                                            const int* rows, int t0, int nrows,
                                            int K, int R, int k0, int k1,
                                            float (*red)[RP],
                                            float (*part)[RP]) {
  constexpr int NG = RP < 16 ? 1 : RP / 16;  // groups of 4 ranks a thread
  // quads whose loads are issued together (element loads take four times
  // the registers)
  constexpr int UK = VEC && NG <= 2 ? 2 : 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rl = tid % kRankLanes, kl = tid / kRankLanes;
  const int nr = min(TR, nrows - t0);
  float acc[TR][NG][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      acc[i][q][0] = acc[i][q][1] = acc[i][q][2] = acc[i][q][3] = 0.0f;
    }
  }
  // rows past nr repeat the tile's last row; their sums are never read
  const float* xr[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    xr[i] = x + static_cast<size_t>(rows[t0 + min(i, nr - 1)]) * K;
  }
  // UK quads at a time: every load of the batch is issued before its first
  // product; a row of a past k1 reads row k1 - 1 and weighs 0 (its x is 0),
  // so the sums run over k in the same order at any UK
  for (int kb = k0 + 4 * kl; kb < k1; kb += 4 * kKLanes * UK) {
    float4 av[UK][4][NG], xv[UK][TR];
#pragma unroll
    for (int u = 0; u < UK; ++u) {
      const int k = kb + 4 * kKLanes * u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* arow = ag + static_cast<size_t>(min(k + j, k1 - 1)) * R;
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          av[u][j][q] = load4<VEC>(arow, 4 * (rl + kRankLanes * q), R);
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) xv[u][i] = load4<VEC>(xr[i], k, k1);
    }
#pragma unroll
    for (int u = 0; u < UK; ++u) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          fma4(acc[i][q], xv[u][i].x, av[u][0][q]);
          fma4(acc[i][q], xv[u][i].y, av[u][1][q]);
          fma4(acc[i][q], xv[u][i].z, av[u][2][q]);
          fma4(acc[i][q], xv[u][i].w, av[u][3][q]);
        }
      }
    }
  }
  // the 8 k-lanes of a warp that share a rank-lane, as a tree
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int q = 0; q < NG; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int off = kRankLanes; off < 32; off *= 2) {
          acc[i][q][e] += __shfl_xor_sync(0xffffffffu, acc[i][q][e], off);
        }
      }
    }
  }
  if (lane < kRankLanes) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int r = 4 * (rl + kRankLanes * q);
        if (i < nr && r < RP) {
          *reinterpret_cast<float4*>(&red[warp * TR + i][r]) = make_float4(
              acc[i][q][0], acc[i][q][1], acc[i][q][2], acc[i][q][3]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * RP; e += kThreads) {
    const int i = e / RP, r = e % RP;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * TR + i][r];
    part[t0 + i][r] = sum;
  }
  __syncthreads();
}

// acc[i] += sum_{j < RU} xa[t0 + i, r0 + j] * bq[j] for the tile's nr rows.
template <int RP, int RU>
__device__ __forceinline__ void fma_rows(float (&acc)[kRowTile][4],
                                         const float4 (&bq)[RU],
                                         float (*xa)[RP], int t0, int r0,
                                         int nr) {
#pragma unroll
  for (int i = 0; i < kRowTile; ++i) {
    if (i < nr) {
#pragma unroll
      for (int j = 0; j < RU; ++j) fma4(acc[i], xa[t0 + i][r0 + j], bq[j]);
    }
  }
}

// out[rows[t0 + i], n .. n + 3] = scale * acc[i] for the tile's nr rows.
template <bool VEC>
__device__ __forceinline__ void store_rows(const float (&acc)[kRowTile][4],
                                           const int* rows, int t0, int nr,
                                           float* __restrict__ out, int N,
                                           int n, int n1, float scale) {
#pragma unroll
  for (int i = 0; i < kRowTile; ++i) {
    if (i < nr) {
      store4<VEC>(out + static_cast<size_t>(rows[t0 + i]) * N, n, n1,
                  make_float4(scale * acc[i][0], scale * acc[i][1],
                              scale * acc[i][2], scale * acc[i][3]));
    }
  }
}

// Rows of one page per cluster at rank bucket RP: every block holds the 8
// blocks' partials of them (8 x rows x RP floats, 32 KB at RP >= 16).
__host__ __device__ constexpr int rows_per_cluster(int rp) {
  return rp <= 16 ? kRowsPerCluster : kRowsPerCluster * 16 / rp;
}

// RP: the rank R rounded up to a power of two >= 4 (1 <= R <= RP <= 64);
// ranks past R weigh exactly 0.  VEC: K, R and N multiples of 4 and every
// pointer 16-byte aligned, so x, a, b and out move 16 bytes at a time.
template <int RP, bool VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
grouped_lora_cluster_kernel(const float* __restrict__ x,
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            const int* __restrict__ gidx,
                            float* __restrict__ out, int M, int K, int R,
                            int N, int G, float scale) {
  constexpr int RC = rows_per_cluster(RP);
  // rows per register tile in the shrink (a thread holds 4 ranks of each
  // of RP / 16 groups for every row of the tile)
  constexpr int RT = RP < 16 ? kRowTile : kRowTile * 16 / RP;
  constexpr int RU = RP < (VEC ? 16 : 8) ? RP : (VEC ? 16 : 8);  // b rows held
  static_assert(kWarps * RT <= RC, "the warps' partials fit in xa");
  __shared__ int rows[RC];
  __shared__ int warp_count[kWarps];
  __shared__ __align__(8) uint64_t inbox_full;
  // the cluster's partials, inbox[c] from block c
  __shared__ __align__(16) float inbox[kCluster][RC][RP];
  __shared__ __align__(16) float part[RC][RP];   // this block's partial
  // the row tile's per-warp partials in the shrink, then the cluster's xa
  __shared__ __align__(16) float xa[RC][RP];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = static_cast<int>(hopper::cluster_ctarank());
  const int g = blockIdx.y;
  const int first = blockIdx.z * RC;
  // the inbox barrier, initialised before any peer may write into it: the
  // cluster barrier's wait comes after the scan, which hides its latency,
  // and before the first load of a page (its acquire invalidates L1)
  if (tid == 0) {
    hopper::mbar_init(&inbox_full, 1);
    hopper::fence_barrier_init();
  }
  hopper::cluster_arrive_relaxed();

  // 1. the rows of page g ranked first .. first + RC - 1 among its rows
  int seen = 0;
  for (int m0 = 0; m0 < M && seen < first + RC; m0 += kThreads) {
    const int m = m0 + tid;
    int gm = m < M ? gidx[m] : -1;
    gm = gm < 0 ? 0 : (gm >= G ? G - 1 : gm);
    const bool mine = m < M && gm == g;
    const unsigned bal = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_count[warp] = __popc(bal);
    __syncthreads();
    int rank = seen + __popc(bal & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) rank += warp_count[w];
      total += warp_count[w];
    }
    if (mine && rank >= first && rank < first + RC) rows[rank - first] = m;
    seen += total;
    __syncthreads();                   // warp_count is written again
  }
  const int nrows = min(max(seen - first, 0), RC);
  hopper::cluster_wait();              // every inbox_full is initialised
  if (nrows == 0) return;              // every block of the cluster alike

  // the inbox takes 8 partials of nrows x RP floats.  A peer's bytes may
  // land before this expect_tx: the phase cannot complete before this
  // thread's arrival all the same.
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&inbox_full,
                                  kCluster * nrows * RP * sizeof(float));
  }

  const int Ks = ((K + kCluster - 1) / kCluster + 3) / 4 * 4;
  const int k0 = min(c * Ks, K), k1 = min(k0 + Ks, K);
  const int Ns = ((N + kCluster - 1) / kCluster + 3) / 4 * 4;
  const int n0 = min(c * Ns, N), n1 = min(n0 + Ns, N);
  const float* ag = a + static_cast<size_t>(g) * K * R;
  const float* bg = b + static_cast<size_t>(g) * R * N;

  // 2. one pass: every rank in one register batch, every row in one tile
  // and at most one quad a thread (R <= 16, N <= 8192).  Then the threads
  // that have a quad of the slice load its b values here, so that they
  // arrive under the shrink and the exchange; a rank past R reads row R - 1
  // and weighs 0 (xa is 0 there).
  const int nq = (n1 - n0 + 3) / 4;
  const bool one_pass = RP <= RU && nrows <= kRowTile && nq <= kThreads;
  float4 bv[RU];
  if (one_pass && tid < nq) {
#pragma unroll
    for (int j = 0; j < RU; ++j) {
      bv[j] = load4<VEC>(bg + static_cast<size_t>(min(j, R - 1)) * N,
                         n0 + 4 * tid, n1);
    }
  }

  // 3. shrink: part[i, r] = sum_{k0 <= k < k1} x[rows[i], k] a[g, k, r],
  // in register tiles of RT rows
  for (int t0 = 0; t0 < nrows; t0 += RT) {
    shrink_tile<RP, VEC, RT>(x, ag, rows, t0, nrows, K, R, k0, k1, xa, part);
  }

  // 4. every block's inbox[c] = this block's partial, one 16-byte write a
  // thread (each completing its bytes on the receiver's inbox_full); then
  // xa = the 8 partials summed in rank order, once all have landed, so
  // every block holds the same bits.  A block leaves only after its inbox
  // has filled, so no peer writes into a block that has left.
  for (int w = tid; w < nrows * RP / 4 * kCluster; w += kThreads) {
    const int f = w / kCluster, cc = w % kCluster;
    const int i = f / (RP / 4), r = 4 * (f % (RP / 4));
    hopper::st_async_v4(
        hopper::map_cluster(hopper::smem_addr(&inbox[c][i][r]), cc),
        *reinterpret_cast<const float4*>(&part[i][r]),
        hopper::map_cluster(hopper::smem_addr(&inbox_full), cc));
  }
  hopper::mbar_wait<true>(&inbox_full, 0);
  for (int e = tid; e < nrows * RP; e += kThreads) {
    const int i = e / RP, r = e % RP;
    float sum = 0.0f;
#pragma unroll
    for (int cc = 0; cc < kCluster; ++cc) sum += inbox[cc][i][r];
    xa[i][r] = sum;
  }
  __syncthreads();

  // 5. expand: out[rows[i], n] = scale * sum_r xa[i, r] b[g, r, n] for
  // n0 <= n < n1, four consecutive n a thread, scale last
  if (one_pass) {
    if (tid < nq) {
      float acc[kRowTile][4] = {};
      fma_rows<RP, RU>(acc, bv, xa, 0, 0, nrows);
      store_rows<VEC>(acc, rows, 0, nrows, out, N, n0 + 4 * tid, n1, scale);
    }
    return;
  }
  for (int q = tid; q < nq; q += kThreads) {
    const int n = n0 + 4 * q;
    for (int t0 = 0; t0 < nrows; t0 += kRowTile) {
      const int nr = min(kRowTile, nrows - t0);
      float acc[kRowTile][4] = {};
#pragma unroll 1
      for (int r0 = 0; r0 < RP; r0 += RU) {
        float4 bq[RU];
#pragma unroll
        for (int j = 0; j < RU; ++j) {
          bq[j] = load4<VEC>(bg + static_cast<size_t>(min(r0 + j, R - 1)) * N,
                             n, n1);
        }
        fma_rows<RP, RU>(acc, bq, xa, t0, r0, nr);
      }
      store_rows<VEC>(acc, rows, t0, nr, out, N, n, n1, scale);
    }
  }
}

// The launch floor: the same grid and clusters, no work.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
grouped_lora_empty_kernel() {}

int check_and_grid(int M, int K, int R, int N, int G, dim3* grid) {
  const int rp = R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : R <= 32 ? 32 : 64;
  const int chunks = (M + rows_per_cluster(rp) - 1) / rows_per_cluster(rp);
  if (M <= 0 || N <= 0 || G <= 0 || R < 0 || R > 64 || K < 0 ||
      G > 65535 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *grid = dim3(kCluster, G, chunks);
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool VEC>
void launch(dim3 grid, cudaStream_t s, const float* x, const float* a,
            const float* b, const int* gidx, float* out, int M, int K, int R,
            int N, int G, float scale) {
  if (R <= 4) {
    grouped_lora_cluster_kernel<4, VEC><<<grid, kThreads, 0, s>>>(
        x, a, b, gidx, out, M, K, R, N, G, scale);
  } else if (R <= 8) {
    grouped_lora_cluster_kernel<8, VEC><<<grid, kThreads, 0, s>>>(
        x, a, b, gidx, out, M, K, R, N, G, scale);
  } else if (R <= 16) {
    grouped_lora_cluster_kernel<16, VEC><<<grid, kThreads, 0, s>>>(
        x, a, b, gidx, out, M, K, R, N, G, scale);
  } else if (R <= 32) {
    grouped_lora_cluster_kernel<32, VEC><<<grid, kThreads, 0, s>>>(
        x, a, b, gidx, out, M, K, R, N, G, scale);
  } else {
    grouped_lora_cluster_kernel<64, VEC><<<grid, kThreads, 0, s>>>(
        x, a, b, gidx, out, M, K, R, N, G, scale);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for what the kernel cannot take (R > 64, an empty
// pool, more than 65535 pages or 65535 chunks of rows).  The caller checks
// shapes, types, devices and contiguity; M, N > 0, G >= 1.
extern "C" int grouped_lora_delta_f32(const void* x, const void* a,
                                      const void* b, const void* gidx,
                                      void* out, int M, int K, int R, int N,
                                      int G, float scale, void* stream) {
  dim3 grid;
  const int err = check_and_grid(M, K, R, N, G, &grid);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) {                        // no rank: the delta is 0
    cudaMemsetAsync(out, 0, sizeof(float) * M * static_cast<size_t>(N), s);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = K % 4 == 0 && R % 4 == 0 && N % 4 == 0 && aligned16(x) &&
                   aligned16(a) && aligned16(b) && aligned16(out);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int* gi = static_cast<const int*>(gidx);
  float* of = static_cast<float*>(out);
  if (vec) {
    launch<true>(grid, s, xf, af, bf, gi, of, M, K, R, N, G, scale);
  } else {
    launch<false>(grid, s, xf, af, bf, gi, of, M, K, R, N, G, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same launch (arguments, checks, grid and clusters) of a kernel that
// does nothing: the latency floor that grouped_lora_delta_f32's time is
// read against.
extern "C" int grouped_lora_floor_f32(const void*, const void*, const void*,
                                      const void*, void*, int M, int K, int R,
                                      int N, int G, float, void* stream) {
  dim3 grid;
  const int err = check_and_grid(M, K, R, N, G, &grid);
  if (err != 0) return err;
  grouped_lora_empty_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
