// W8A8 matrix product for Hopper (sm_90a): int8 x int8 -> int32 on the tensor
// cores (or dp4a), scale epilogue fused, output written once.
//
// Replaces duo_attention_tpu/ops/gemm.py::w8a8_matmul (_w8a8_kernel) and the
// small-M dot_general the JAX package leaves to XLA
// (ops/quant.py::int8_matmul): out[m, n] = (float(sum_k x[m,k] * w[n,k]) *
// x_scale[m]) * w_scale[n]. x is [M, K] int8 row-major and w is [N, K] int8
// row-major (PyTorch's [out, in]): both K-major, the one operand form the
// int8 `wgmma` takes, so nothing is transposed. The int32 sum is exact in
// any order and the epilogue is two float32 multiplications with no
// addition to contract, so the result is bitwise that of the plain version.
//
// Two routes, one per shape of work:
//   * tiled (prefill, M in the thousands): bound by operations (2*M*N*K int8
//     operations against 1,979 TOP/s), which only `wgmma` reaches. A block
//     owns a 128 x 256 output tile: two consumer warpgroups of 64 rows each
//     run `wgmma` m64n256k32 s8 from shared memory, keeping their 64 x 256
//     int32 sums in registers (128 a thread; 128 x 256 is the widest tile
//     that fits beside them in 232 registers, and the two warpgroups share
//     every w slab, so it reads half the bytes a 128 x 128 tile would). One
//     producer thread feeds a 4-stage ring of 128-byte K slabs (x: 128 rows,
//     w: 256 rows, 48 KB a stage) by TMA: plain 2-D row-major operands, boxes
//     land in the 128-byte swizzle the descriptors read, and rows and k past
//     the matrix's edge arrive as zeros, so ragged M, N and K cost nothing
//     but the masked store. Stages change hands through `mbarrier`s (full:
//     the boxes' bytes have landed; empty: every consumer warp is done); a
//     slab's products run while the next slab's are issued, and the loop has
//     no branch around a `wgmma` or its wait. M tiles vary fastest over the
//     grid, so the blocks that run together share w and x stays in L2. The
//     tensor maps are made per call on the host, through the CUDA entry
//     point the runtime looks up (no -lcuda). What still holds it back: on an
//     H100 the long-K down projection (4096 x 14336) runs at 72% of the int8
//     peak but the K = 4096 shapes at about 50%, so some cost comes with each
//     tile rather than each slab; a persistent walk (one block an SM, the
//     next tile's slabs loaded under this one's epilogue) was no faster, so
//     it is not the ring's fill. The epilogue stores straight from the
//     accumulators, two bytes or four an element, not through shared memory.
//   * small M (decode, M = batch): bound by bytes, every weight is read once
//     (K*N bytes; the int8 weights of one 8B decode step are 7.5 GB). One
//     warp per output column n streams w[n, :] in 16-byte vectors and keeps
//     up to 8 rows of x (read through L1) as dp4a accumulators; a shuffle
//     reduction ends it. More than 8 rows run as further row blocks
//     (grid.y), which re-read w from L2.
//
// Launches go on the caller's stream and allocate nothing (the tensor maps
// are kernel parameters).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

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
// Tiled route: TMA, an mbarrier ring, wgmma s8 from two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 256, BK = 128;  // BK in bytes = int8 elements: one swizzled row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int TILE_THREADS = 384;  // two consumer warpgroups (64 rows each) and one producer
// + 2 * STAGES barriers of 8 bytes, + room to align to 1024
constexpr int TILED_SMEM = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
static_assert(TILED_SMEM <= 232448, "the block's shared memory exceeds the SM's");

// D[64x256] += A[64x32] B[256x32]^T in int8 -> int32, both operands K-major
// in shared memory (128-byte swizzle). Integer wgmma has no transpose bits.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A box of the tensor map at (k0, row0) into shared memory; the barrier's
// transaction count falls by the box's bytes when it lands (rows and k past
// the matrix's edge are zeros).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

template <typename OutT>
__global__ void __launch_bounds__(TILE_THREADS, 1) w8a8_tiled_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ xs, const float* __restrict__ ws, OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the swizzled boxes need 1024-byte alignment
  const uint32_t base = smem_addr(smem) + ((1024u - (smem_addr(smem) & 1023u)) & 1023u);
  // stage s: x rows [BM][BK] at base + s * STAGE_BYTES, then w rows [BN][BK];
  // full[s]: both boxes have landed; empty[s]: every consumer warp is done with them
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  // M tiles vary fastest across the grid: the blocks running at once share
  // a few w tiles, and x stays in L2 while w streams through once
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: one thread keeps STAGES slabs of x and w in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, (kt / STAGES + 1) & 1);
        mbar_arrive_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(base + s * STAGE_BYTES, &xmap, kt * BK, m0, full + 8 * s);
        tma_load_2d(base + s * STAGE_BYTES + A_BYTES, &wmap, kt * BK, n0, full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  // one 128-byte slab: four k-steps of 32 bytes inside the swizzled rows
  auto issue = [&](int kt) {
    const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
    const uint64_t da = make_desc(st + wg * 64 * BK, 16, 1024), db = make_desc(st + A_BYTES, 16, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
  };
  auto wait_full = [&](int kt) { mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1); };

  // Slab kt is multiplied while slab kt - 1's products finish; a stage is
  // released once its products are complete. No branch around a wgmma or its
  // wait in the loop (ptxas serializes them otherwise).
  wait_full(0);
  issue(0);
  for (int kt = 1; kt < nk; ++kt) {
    wait_full(kt);
    issue(kt);
    wgmma_wait<1>();
    if (lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: element 4j + e of the accumulator is row r0 + 8 * (e >> 1),
  // column 8j + 2 * (lane & 3) + (e & 1).
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + r0 + 8 * half;
    if (m >= M) continue;
    const float sx = xs[m];
    OutT* orow = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + cq;  // even
      const int a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
      if (n + 1 < N && (N & 1) == 0) {
        const float2 w2 = *reinterpret_cast<const float2*>(ws + n);
        store_pair(orow + n, epilogue(a0, sx, w2.x), epilogue(a1, sx, w2.y));
      } else {
        if (n < N) store_out(orow + n, epilogue(a0, sx, ws[n]));
        if (n + 1 < N) store_out(orow + n + 1, epilogue(a1, sx, ws[n + 1]));
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [rows, K] int8 row-major matrix as boxes of [box_rows][BK] in the 128-byte
// swizzle; boxes past the edge read zeros.
bool make_map(CUtensorMap* map, const int8_t* p, int rows, int K, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
    CUtensorMap xmap, wmap;
    if (!make_map(&xmap, x, M, K, BM) || !make_map(&wmap, w, N, K, BN))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_tiled_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, TILED_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    w8a8_tiled_kernel<OutT><<<grid, TILE_THREADS, TILED_SMEM, stream>>>(xmap, wmap, xs, ws, out, M, N, K);
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
