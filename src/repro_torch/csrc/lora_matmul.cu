// Fused single-adapter LoRA matmul for Hopper, sm_90a.
//
//   y = x @ w + scale * (xa @ b)          xa = (x @ a) rounded to x's dtype
//
// x (M, K), w (K, N), xa (M, r), b (r, N), y (M, N), all contiguous and of
// one dtype: bf16 or f32.  Both products accumulate in f32; the sum is
// rounded to the dtype once.  xa is computed by the caller (torch.matmul),
// as the reference computes it outside its kernel.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py::
// lora_matmul_pallas (its `_kernel`): an f32 accumulator over K tiles, and
// the low-rank product added in the epilogue, so y = x @ w never makes a
// round trip through device memory.  Any M, N, K and r: the ragged tiles are
// masked (the Pallas kernel needs M % 128, N % 128 and K % bk to be 0).
//
// What bounds it on an H100: at the long-prompt shapes (M = 8192 rows,
// K = 4096, N = 4096, r = 16) a bf16 call does 2 M N (K + r) = 2.76e11
// flop against 0.16 GB of operands: 0.28 ms of tensor-core work against
// 0.05 ms of bytes.  It is bound by operations, so the design goal is to
// keep the tensor cores fed.
//
// Three kernels; the caller (kernels/lora_matmul.py::lora_route) picks one
// from dtype and shape alone, before the launch, and passes it as `route`:
//
//   route 0, "wgmma" -- bf16 with K % 8 == 0, K > 0 and N % 8 == 0 (TMA
//     needs 16-byte row strides): every Yi-9B projection.  128 x 256
//     output tiles; two consumer warpgroups of 64 rows and one producer
//     warpgroup, of which one thread issues TMA loads of 64-deep slabs of
//     x (K-major, one 128 x 64 box) and w (MN-major, four 64 x 64 boxes)
//     into a ring of four 48 KB stages, each with a full and an empty
//     mbarrier.  The math is wgmma m64n256k16 from shared memory, w read
//     through the transpose bit; the next slab's products are issued
//     before this slab's are waited for (wgmma.wait_group 1), and only
//     then is the slab's stage released.  TMA zero-fills past M, K and N.
//     Low-rank epilogue: per 8-column chunk of the accumulator, one
//     mma.sync m16n8k16 per 16 ranks (xa and b read from global memory, f32
//     accumulate) gives xa @ b for exactly the chunk's outputs; then y =
//     acc + scale * lora, rounded once.  setmaxnreg gives the producer 40
//     registers and the consumers 232.  Not yet: a persistent tile
//     scheduler (one block's epilogue under the next one's loads) and
//     clusters (one TMA load feeding two blocks).
//   route 1, "mma_sync" -- the first version, for the bf16 shapes that
//     route 0 does not take (K or N not a multiple of 8, or K = 0): 128 x
//     128 output tiles, 8 warps as 2 x 4, each warp 64 x 32 as 4 x 4
//     mma.sync.m16n8k16 tiles (bf16 in, f32 accumulate).  K advances 32 at
//     a time through two shared-memory stages, the next x and w tiles
//     loaded element by element (zero past M, K or N) before this one is
//     multiplied.  Fragments come by ldmatrix, the w tile's (row-major, k
//     by n) by ldmatrix.trans; rows are padded by 8 bf16 so each 8-row
//     phase hits 32 distinct banks.
//   route 2, "fma" -- f32: 64 x 64 output tiles, 256 threads as 16 x 16,
//     each thread 4 x 4 outputs by FMA (never TF32, which would move f32
//     results by 1e-3).
//   Routes 1 and 2 share their epilogue: xa and b in chunks of 16 ranks
//   through shared memory as f32; each thread sums its outputs' low-rank
//   products by FMA, then writes acc + scale * lora.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64, kBN = 64;
constexpr int kRC = 16;             // ranks per epilogue chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Low-rank epilogue shared by both kernels: lora[i][j] = sum_r xa[m0 +
// rows[i], r] * b[r, n0 + cols[j]] for the thread's outputs (rows and cols
// index the BM x BN tile; entries past M, N or R read as zeros).  xas and
// bs hold BM x kRC and kRC x BN floats.
template <int BM, int BN, typename T, int NI, int NJ>
__device__ __forceinline__ void lora_epilogue(
    const T* __restrict__ xa, const T* __restrict__ b, int M, int N, int R,
    int m0, int n0, const int (&rows)[NI], const int (&cols)[NJ],
    float (&lora)[NI][NJ], float* xas, float* bs, int tid, int nthreads) {
  for (int r0 = 0; r0 < R; r0 += kRC) {
    __syncthreads();
    for (int i = tid; i < BM * kRC; i += nthreads) {
      const int mr = i / kRC, rr = i % kRC;
      xas[i] = (m0 + mr < M && r0 + rr < R)
                   ? to_f32(xa[static_cast<size_t>(m0 + mr) * R + r0 + rr])
                   : 0.0f;
    }
    for (int i = tid; i < kRC * BN; i += nthreads) {
      const int rr = i / BN, nc = i % BN;
      bs[i] = (r0 + rr < R && n0 + nc < N)
                  ? to_f32(b[static_cast<size_t>(r0 + rr) * N + n0 + nc])
                  : 0.0f;
    }
    __syncthreads();
    const int rn = min(kRC, R - r0);
    for (int rr = 0; rr < rn; ++rr) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          lora[i][j] = fmaf(xas[rows[i] * kRC + rr], bs[rr * BN + cols[j]],
                            lora[i][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route 1, bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBM16 = 128, kBN16 = 128, kBK16 = 32;
constexpr int kLDX = kBK16 + 8;     // x tile row (bf16): 80 bytes
constexpr int kLDW = kBN16 + 8;     // w tile row (bf16): 272 bytes
constexpr int kThreadsMma = 256;    // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

struct Bf16Smem {                  // two stages of the x and w tiles
  __nv_bfloat16 xs[2][kBM16][kLDX];
  __nv_bfloat16 ws[2][kBK16][kLDW];
};

__global__ void __launch_bounds__(kThreadsMma)
lora_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ xa,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ y, int M, int K, int N,
                        int R, float scale) {
  __shared__ __align__(16) unsigned char smem_raw[sizeof(Bf16Smem)];
  static_assert(sizeof(Bf16Smem) >= 4 * kRC * (kBM16 + kBN16),
                "the epilogue reuses the tile buffers");
  Bf16Smem& sm = *reinterpret_cast<Bf16Smem*>(smem_raw);
  const int m0 = blockIdx.y * kBM16, n0 = blockIdx.x * kBN16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  auto load_tile = [&](int k0, int buf) {
    for (int i = tid; i < kBM16 * kBK16; i += kThreadsMma) {
      const int r = i / kBK16, c = i % kBK16;
      sm.xs[buf][r][c] = (m0 + r < M && k0 + c < K)
          ? x[static_cast<size_t>(m0 + r) * K + k0 + c] : zero;
    }
    for (int i = tid; i < kBK16 * kBN16; i += kThreadsMma) {
      const int r = i / kBN16, c = i % kBN16;
      sm.ws[buf][r][c] = (k0 + r < K && n0 + c < N)
          ? w[static_cast<size_t>(k0 + r) * N + n0 + c] : zero;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
    }
  }
  const int n_k = (K + kBK16 - 1) / kBK16;
  if (n_k > 0) load_tile(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) load_tile((kt + 1) * kBK16, (kt + 1) & 1);
    __syncthreads();
    const int buf = kt & 1;
#pragma unroll
    for (int kk = 0; kk < kBK16 / 16; ++kk) {
      // A: matrix i is rows (i & 1) * 8.., cols (i >> 1) * 8.. of a 16 x 16
      // block; B: rows (keys of K) (i & 1) * 8.., n-tile (i >> 1) of a pair
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldsm_x4(af[mi], &sm.xs[buf][wm + mi * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)][kk * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r4[4];
        ldsm_x4_trans(r4, &sm.ws[buf][kk * 16 + ((lane >> 3) & 1) * 8 +
                                      (lane & 7)]
                                     [wn + (2 * nj + (lane >> 4)) * 8]);
        bf[2 * nj][0] = r4[0];
        bf[2 * nj][1] = r4[1];
        bf[2 * nj + 1][0] = r4[2];
        bf[2 * nj + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
      }
    }
    __syncthreads();                  // buffer kt & 1 is free for kt + 2
  }

  // this thread's outputs: rows wm + 16 mi + g (+ 8), cols wn + 8 ni + 2t (+ 1)
  int rows[8], cols[8];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    rows[2 * mi] = wm + mi * 16 + g;
    rows[2 * mi + 1] = wm + mi * 16 + g + 8;
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    cols[2 * ni] = wn + ni * 8 + 2 * t;
    cols[2 * ni + 1] = wn + ni * 8 + 2 * t + 1;
  }
  float lora[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) lora[i][j] = 0.0f;
  }
  float* xas = reinterpret_cast<float*>(smem_raw);
  lora_epilogue<kBM16, kBN16>(xa, b, M, N, R, m0, n0, rows, cols, lora, xas,
                              xas + kBM16 * kRC, tid, kThreadsMma);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + rows[i];
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cols[j];
      if (n >= N) continue;
      const float a = acc[i >> 1][j >> 1][(i & 1) * 2 + (j & 1)];
      store(y + static_cast<size_t>(m) * N + n, a + scale * lora[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// route 0, bf16: TMA, an mbarrier ring, wgmma, a producer warpgroup
// ---------------------------------------------------------------------------

constexpr int kGBM = 128, kGBN = 256, kGBK = 64;
constexpr int kGStages = 4;
constexpr int kGThreads = 384;          // consumers: warpgroups 0, 1; producer: 2
constexpr int kGProducerRegs = 40;   // setmaxnreg, per thread
constexpr int kGConsumerRegs = 232;   // (40 + 2 x 232) x 128 = 168 x 384
constexpr int kXBox = kGBM * kGBK * 2;  // the x slab: 128 rows x 64 k, 16 KB
constexpr int kWBox = kGBK * 64 * 2;    // one 64-column box of the w slab, 8 KB
constexpr int kGStage = kXBox + (kGBN / 64) * kWBox;   // 48 KB
constexpr int kGSmem = 1024 + kGStages * kGStage + 16 * kGStages;

__global__ void __launch_bounds__(kGThreads, 1)
lora_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __nv_bfloat16* __restrict__ xa,
                         const __nv_bfloat16* __restrict__ b,
                         __nv_bfloat16* __restrict__ y, int M, int K, int N,
                         int R, float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kGStages * kGStage);
  uint64_t* empty = full + kGStages;
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;
  const int n_k = (K + kGBK - 1) / kGBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kGProducerRegs>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kGStages;
        const uint32_t ph = (kt / kGStages) & 1;
        uint8_t* st = base + s * kGStage;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&full[s], kGStage);
        tma_load_2d(st, &tm_x, &full[s], kt * kGBK, m0);
#pragma unroll
        for (int i = 0; i < kGBN / 64; ++i) {
          tma_load_2d(st + kXBox + i * kWBox, &tm_w, &full[s], n0 + 64 * i,
                      kt * kGBK);
        }
      }
    }
  } else {
    setmaxnreg_inc<kGConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kGStages;
      const uint32_t ph = (kt / kGStages) & 1;
      const uint32_t st = smem_addr(base + s * kGStage);
      mbar_wait(&full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGBK / 16; ++kk) {
        wgmma_m64n256k16_ss(
            acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
            desc_sw128(st + kXBox + kk * 2048, kWBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // slab kt - 1's products are done
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(kt - 1) % kGStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // low-rank epilogue: rows r_lo, r_hi; acc[4 j + e] is column n0 + 8 j +
    // 2 t + (e & 1).  mma.sync's A fragment is xa[rows, ranks 2t, 2t+1,
    // 2t+8, 2t+9], its B fragment b[those ranks, column n0 + 8 j + g].
    const int r_lo = m0 + wg * 64 + warp * 16 + g, r_hi = r_lo + 8;
    const uint16_t* xa16 = reinterpret_cast<const uint16_t*>(xa);
    const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
    auto xa_at = [&](int row, int r) -> uint32_t {
      return (row < M && r < R) ? xa16[static_cast<size_t>(row) * R + r] : 0u;
    };
    auto b_at = [&](int r, int col) -> uint32_t {
      return (r < R && col < N) ? b16[static_cast<size_t>(r) * N + col] : 0u;
    };
    auto xa_frag = [&](uint32_t (&af)[4], int r0) {
      const int ra = r0 + 2 * t, rb = ra + 8;
      af[0] = xa_at(r_lo, ra) | (xa_at(r_lo, ra + 1) << 16);
      af[1] = xa_at(r_hi, ra) | (xa_at(r_hi, ra + 1) << 16);
      af[2] = xa_at(r_lo, rb) | (xa_at(r_lo, rb + 1) << 16);
      af[3] = xa_at(r_hi, rb) | (xa_at(r_hi, rb + 1) << 16);
    };
    uint32_t af0[4];
    xa_frag(af0, 0);
#pragma unroll
    for (int j = 0; j < kGBN / 8; ++j) {
      const int col = n0 + 8 * j + g;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int r0 = 0; r0 < R; r0 += 16) {
        uint32_t af[4] = {af0[0], af0[1], af0[2], af0[3]};
        if (r0 > 0) xa_frag(af, r0);
        const int ra = r0 + 2 * t, rb = ra + 8;
        mma_bf16(d, af, b_at(ra, col) | (b_at(ra + 1, col) << 16),
                 b_at(rb, col) | (b_at(rb + 1, col) << 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] += scale * d[e];
    }
#pragma unroll
    for (int j = 0; j < kGBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;   // N % 8 == 0: col + 1 < N too
      if (col >= N) continue;
      if (r_lo < M) {
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(r_lo) * N +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      }
      if (r_hi < M) {
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(r_hi) * N +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

int launch_wgmma(const void* x, const void* w, const void* xa, const void* b,
                 void* y, int M, int K, int N, int R, float scale,
                 cudaStream_t stream) {
  CUtensorMap tx, tw;
  const uint64_t xdim[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xstr[1] = {2ull * K};
  const uint32_t xbox[2] = {kGBK, kGBM};
  const uint64_t wdim[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t wstr[1] = {2ull * N};
  const uint32_t wbox[2] = {64, kGBK};
  int err = hopper::make_tensor_map_bf16(&tx, x, 2, xdim, xstr, xbox);
  if (err == 0) err = hopper::make_tensor_map_bf16(&tw, w, 2, wdim, wstr, wbox);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      lora_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kGBN - 1) / kGBN, (M + kGBM - 1) / kGBM);
  lora_matmul_wgmma_kernel<<<grid, kGThreads, kGSmem, stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(xa),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), M,
      K, N, R, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route 2, f32: FMA
// ---------------------------------------------------------------------------

constexpr int kBK32 = 16;
constexpr int kThreadsF32 = 256;    // 16 x 16

__global__ void __launch_bounds__(kThreadsF32)
lora_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ xa, const float* __restrict__ b,
                       float* __restrict__ y, int M, int K, int N, int R,
                       float scale) {
  __shared__ float xts[kBK32][kBM + 1];   // x tile transposed: [k][m]
  __shared__ float ws[kBK32][kBN];        // [k][n]
  __shared__ float xas[kBM * kRC];
  __shared__ float bs[kRC * kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    for (int i = tid; i < kBM * kBK32; i += kThreadsF32) {
      const int r = i / kBK32, c = i % kBK32;
      xts[c][r] = (m0 + r < M && k0 + c < K)
                      ? x[static_cast<size_t>(m0 + r) * K + k0 + c] : 0.0f;
    }
    for (int i = tid; i < kBK32 * kBN; i += kThreadsF32) {
      const int r = i / kBN, c = i % kBN;
      ws[r][c] = (k0 + r < K && n0 + c < N)
                     ? w[static_cast<size_t>(k0 + r) * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xts[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  int rows[4], cols[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = ty + 16 * i;
    cols[i] = tx + 16 * i;
  }
  float lora[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) lora[i][j] = 0.0f;
  }
  lora_epilogue<kBM, kBN>(xa, b, M, N, R, m0, n0, rows, cols, lora, xas, bs,
                          tid, kThreadsF32);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rows[i];
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cols[j];
      if (n < N) store(y + static_cast<size_t>(m) * N + n,
                       acc[i][j] + scale * lora[i][j]);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks devices, dtypes, shapes and contiguity, and that x and w
// are 16-byte aligned; M, N >= 1, K, R >= 0.  dtype 0 = bf16, 1 = f32.
// route 0 = wgmma (bf16, K % 8 == 0, K > 0, N % 8 == 0), 1 = mma_sync
// (the other bf16 shapes), 2 = fma (f32); a route that the dtype and shape
// do not select is refused.
extern "C" int lora_matmul_fwd(const void* x, const void* w, const void* xa,
                               const void* b, void* y, int M, int K, int N,
                               int R, int dtype, float scale, int route,
                               void* stream) {
  const bool tma = K > 0 && K % 8 == 0 && N % 8 == 0;
  const bool fits = (route == 0 && dtype == 0 && tma) ||
                    (route == 1 && dtype == 0 && !tma) ||
                    (route == 2 && dtype == 1);
  if (M <= 0 || N <= 0 || K < 0 || R < 0 || !fits ||
      (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) return launch_wgmma(x, w, xa, b, y, M, K, N, R, scale, s);
  if (route == 1) {
    const dim3 grid((N + kBN16 - 1) / kBN16, (M + kBM16 - 1) / kBM16);
    lora_matmul_bf16_kernel<<<grid, kThreadsMma, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(xa),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
        M, K, N, R, scale);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    lora_matmul_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(xa), static_cast<const float*>(b),
        static_cast<float*>(y), M, K, N, R, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel's dynamic shared memory and its setmaxnreg counts (the
// build report prints them beside ptxas's).
extern "C" void lora_matmul_wgmma_config(int* smem_bytes, int* producer_regs,
                                    int* consumer_regs) {
  *smem_bytes = kGSmem;
  *producer_regs = kGProducerRegs;
  *consumer_regs = kGConsumerRegs;
}
