// W8A8 matrix product for Hopper (sm_90a): int8 x int8 -> int32 on the tensor
// cores (or dp4a), scale epilogue fused, output written once.
//
// Replaces duo_attention_tpu/ops/gemm.py::w8a8_matmul (_w8a8_kernel) and the
// small-M dot_general the JAX package leaves to XLA
// (ops/quant.py::int8_matmul): out[m, n] = (float(sum_k x[m,k] * w[n,k]) *
// x_scale[m]) * w_scale[n]. x is [M, K] int8 row-major and w is [N, K] int8
// row-major (PyTorch's [out, in]), which is the "row-major A, column-major
// B" operand form of the int8 tensor-core instruction, so nothing is
// transposed. The int32 sum is exact in any order and the epilogue is two
// float32 multiplications with no addition to contract, so the result is
// bitwise that of the plain version.
//
// Two routes, one per shape of work:
//   * tiled (prefill, M in the thousands): bound by operations (2*M*N*K int8
//     operations against 1,979 TOP/s). One block of 8 warps per 128 x 128
//     output tile; 64-byte K slabs of x and w stream through a 3-stage
//     cp.async ring in shared memory; each warp owns a 64 x 32 sub-tile as
//     4 x 4 mma.sync.m16n8k32.s8 accumulators (64 int32 registers). Ragged M,
//     N and K edges are zero-filled on load and masked on store. This is the
//     simple first version: mma.sync from shared memory without wgmma/TMA.
//   * small M (decode, M = batch): bound by bytes, every weight is read once
//     (K*N bytes; the int8 weights of one 8B decode step are 7.5 GB). One
//     warp per output column n streams w[n, :] in 16-byte vectors and keeps
//     up to 8 rows of x (read through L1) as dp4a accumulators; a shuffle
//     reduction ends it. More than 8 rows run as further row blocks
//     (grid.y), which re-read w from L2.
//
// Launches go on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }
// Two adjacent outputs at an even element offset, in one store.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// (float(acc) * x_scale) * w_scale: two roundings, in this order.
__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), xs), ws);
}

// ---------------------------------------------------------------------------
// Tiled route
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64;  // BK in bytes = int8 elements
constexpr int STAGES = 3;
constexpr int LDT = BK + 16;  // padded row: 20 words, so 8 rows x 4 words hit 32 banks once
constexpr int TILE_THREADS = 256;
constexpr int WM = 64, WN = 32;  // warp tile: 2 x 4 warps
constexpr size_t TILED_SMEM = (size_t)STAGES * (BM + BN) * LDT;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage one BK slab: rows [row0, row0 + 128) of src [rows, K] into dst
// [128][LDT]; 16-byte chunks past the matrix edge are zero-filled (K % 16 == 0).
__device__ __forceinline__ void load_slab(int8_t* dst, const int8_t* src, int row0, int rows,
                                          int k0, int K) {
  for (int i = threadIdx.x; i < 128 * (BK / 16); i += TILE_THREADS) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const int gr = row0 + r, gk = k0 + c;
    const bool in = gr < rows && gk < K;
    const int8_t* g = src + (in ? (size_t)gr * K + gk : 0);
    cp_async16(dst + r * LDT + c, g, in ? 16 : 0);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(TILE_THREADS) w8a8_tiled_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ xs, const int8_t* __restrict__ w,
    const float* __restrict__ ws, OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem_raw);  // [STAGES][BM][LDT]
  int8_t* sB = sA + STAGES * BM * LDT;                // [STAGES][BN][LDT]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int grp = lane >> 2, tig = lane & 3;
  const int nk = (K + BK - 1) / BK;

  int acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // Prologue: STAGES - 1 slabs in flight (an empty group where there is none).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_slab(sA + s * BM * LDT, x, m0, M, s * BK, K);
      load_slab(sB + s * BN * LDT, w, n0, N, s * BK, K);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed (this thread's copies)
    __syncthreads();              // ... and everyone's; slab kt-1's readers are done
    {
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) {
        const int s = nxt % STAGES;
        load_slab(sA + s * BM * LDT, x, m0, M, nxt * BK, K);
        load_slab(sB + s * BN * LDT, w, n0, N, nxt * BK, K);
      }
      cp_async_commit();
    }
    const int8_t* a = sA + (kt % STAGES) * BM * LDT;
    const int8_t* b = sB + (kt % STAGES) * BN * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t fa[WM / 16][4], fb[WN / 8][2];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        const int8_t* p = a + (wm + i * 16 + grp) * LDT + kk + tig * 4;
        fa[i][0] = *reinterpret_cast<const uint32_t*>(p);
        fa[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDT);
        fa[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        fa[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDT + 16);
      }
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int8_t* p = b + (wn + j * 8 + grp) * LDT + kk + tig * 4;
        fb[j][0] = *reinterpret_cast<const uint32_t*>(p);
        fb[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator (i, j) holds rows grp and grp + 8, columns 2*tig and 2*tig + 1.
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + grp + half * 8;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;  // even
        if (n + 1 < N && (N & 1) == 0) {
          store_pair(out + (size_t)m * N + n, epilogue(acc[i][j][half * 2], sx, ws[n]),
                     epilogue(acc[i][j][half * 2 + 1], sx, ws[n + 1]));
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (n + c < N)
              store_out(out + (size_t)m * N + n + c, epilogue(acc[i][j][half * 2 + c], sx, ws[n + c]));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Small-M route
// ---------------------------------------------------------------------------

constexpr int SMALL_WARPS = 8;  // output columns per block

template <typename OutT, int MT>
__global__ void __launch_bounds__(SMALL_WARPS * 32) w8a8_small_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ xs, const int8_t* __restrict__ w,
    const float* __restrict__ ws, OutT* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * SMALL_WARPS + warp;
  const int m0 = blockIdx.y * MT;
  if (n >= N) return;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * K);
  const int nvec = K / 16;
  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;
#pragma unroll 4
  for (int v = lane; v < nvec; v += 32) {
    const uint4 wv = wrow[v];
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int m = min(m0 + r, M - 1);  // rows past M repeat the last one and are not stored
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K) + v);
      int a = acc[r];
      a = __dp4a(static_cast<int>(xv.x), static_cast<int>(wv.x), a);
      a = __dp4a(static_cast<int>(xv.y), static_cast<int>(wv.y), a);
      a = __dp4a(static_cast<int>(xv.z), static_cast<int>(wv.z), a);
      a = __dp4a(static_cast<int>(xv.w), static_cast<int>(wv.w), a);
      acc[r] = a;
    }
  }
  const float sw = ws[n];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    int a = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    const int m = m0 + r;
    if (lane == 0 && m < M) store_out(out + (size_t)m * N + n, epilogue(a, xs[m], sw));
  }
}

template <typename OutT>
int launch(const int8_t* x, const float* xs, const int8_t* w, const float* ws, OutT* out, int M,
           int N, int K, int route, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_tiled_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILED_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w8a8_tiled_kernel<OutT><<<grid, TILE_THREADS, TILED_SMEM, stream>>>(x, xs, w, ws, out, M, N, K);
  } else {
    const int cols = (N + SMALL_WARPS - 1) / SMALL_WARPS;
#define DUO_SMALL_CASE(MT)                                                            \
  w8a8_small_kernel<OutT, MT><<<dim3(cols, (M + MT - 1) / MT), SMALL_WARPS * 32, 0, stream>>>( \
      x, xs, w, ws, out, M, N, K)
    if (M == 1) DUO_SMALL_CASE(1);
    else if (M == 2) DUO_SMALL_CASE(2);
    else if (M <= 4) DUO_SMALL_CASE(4);
    else DUO_SMALL_CASE(8);
#undef DUO_SMALL_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// x [M, K] int8; x_scale [M] f32; w [N, K] int8; w_scale [N] f32; out [M, N]
// bf16 (out_f32 == 0) or f32. route 0: tiled tensor-core kernel; 1: small-M
// kernel. K must be a multiple of 16.
int w8a8_matmul(const void* x, const void* x_scale, const void* w, const void* w_scale, void* out,
                int M, int N, int K, int out_f32, int route, void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* xsp = static_cast<const float*>(x_scale);
  const float* wsp = static_cast<const float*>(w_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != 0 && route != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_f32) return launch<float>(xp, xsp, wp, wsp, static_cast<float*>(out), M, N, K, route, s);
  return launch<bf16>(xp, xsp, wp, wsp, static_cast<bf16*>(out), M, N, K, route, s);
}

}  // extern "C"
