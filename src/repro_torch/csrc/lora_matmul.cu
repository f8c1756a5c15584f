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
// 0.05 ms of bytes.  It is bound by operations.
//
// Design (first version: right and simple; wgmma and TMA are later work):
//   bf16: 128 x 128 output tiles, 8 warps as 2 x 4, each warp 64 x 32 as
//     4 x 4 mma.sync.m16n8k16 tiles (bf16 in, f32 accumulate).  K advances
//     32 at a time through two shared-memory stages: the next x and w tiles
//     are copied by cp.async (16 bytes a thread, zero-filled past M, K or
//     N) while this one is multiplied.  Fragments come by ldmatrix, the w
//     tile's (row-major, k by n) by ldmatrix.trans; rows are padded by 8
//     bf16 so each 8-row phase hits 32 distinct banks.  Where K or N is not
//     a multiple of 8 (or x, w are not 16-byte aligned) the tiles are
//     loaded element by element instead.
//   f32: 64 x 64 output tiles, 256 threads as 16 x 16, each thread 4 x 4
//     outputs by FMA (never TF32, which would move f32 results by 1e-3).
//   Epilogue (both): xa and b in chunks of 16 ranks through shared memory as
//     f32; each thread sums its outputs' low-rank products by FMA, then
//     writes acc + scale * lora.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16: mma.sync m16n8k16
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

struct Bf16Smem {                  // two stages of the x and w tiles
  __nv_bfloat16 xs[2][kBM16][kLDX];
  __nv_bfloat16 ws[2][kBK16][kLDW];
};

// VEC: K % 8 == 0, N % 8 == 0 and 16-byte aligned x, w: every 8-element
// chunk of a tile row is wholly inside or wholly outside the matrix and is
// copied by cp.async.  Otherwise element by element.
template <bool VEC>
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
    if constexpr (VEC) {
      for (int i = tid; i < kBM16 * kBK16 / 8; i += kThreadsMma) {
        const int r = i / (kBK16 / 8), c = (i % (kBK16 / 8)) * 8;
        const bool in = m0 + r < M && k0 + c < K;
        cp_async16(&sm.xs[buf][r][c],
                   x + (in ? static_cast<size_t>(m0 + r) * K + k0 + c : 0), in);
      }
      for (int i = tid; i < kBK16 * kBN16 / 8; i += kThreadsMma) {
        const int r = i / (kBN16 / 8), c = (i % (kBN16 / 8)) * 8;
        const bool in = k0 + r < K && n0 + c < N;
        cp_async16(&sm.ws[buf][r][c],
                   w + (in ? static_cast<size_t>(k0 + r) * N + n0 + c : 0), in);
      }
    } else {
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
    }
    cp_async_commit();
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
    if (kt + 1 < n_k) {
      load_tile((kt + 1) * kBK16, (kt + 1) & 1);
      cp_async_wait<1>();             // tile kt has landed, kt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
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
// f32: FMA
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
// caller checks devices, dtypes, shapes and contiguity; M, N >= 1, K, R >= 0.
// dtype 0 = bf16, 1 = f32.
extern "C" int lora_matmul_fwd(const void* x, const void* w, const void* xa,
                               const void* b, void* y, int M, int K, int N,
                               int R, int dtype, float scale, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || R < 0 || (dtype != 0 && dtype != 1) ||
      (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + kBN16 - 1) / kBN16, (M + kBM16 - 1) / kBM16);
    const bool vec = K % 8 == 0 && N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* xab = static_cast<const __nv_bfloat16*>(xa);
    auto* bb = static_cast<const __nv_bfloat16*>(b);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (vec) {
      lora_matmul_bf16_kernel<true><<<grid, kThreadsMma, 0, s>>>(
          xb, wb, xab, bb, yb, M, K, N, R, scale);
    } else {
      lora_matmul_bf16_kernel<false><<<grid, kThreadsMma, 0, s>>>(
          xb, wb, xab, bb, yb, M, K, N, R, scale);
    }
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    lora_matmul_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(xa), static_cast<const float*>(b),
        static_cast<float*>(y), M, K, N, R, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
