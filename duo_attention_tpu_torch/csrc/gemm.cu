// W8A8 matrix product for Hopper (sm_90a): int8 x int8 -> int32 on the tensor
// cores, scale epilogue fused, output written once.
//
// Replaces duo_attention_tpu/ops/gemm.py::w8a8_matmul (_w8a8_kernel) and
// what the JAX package leaves to XLA below M = 256,
// ops/quant.py::_w8a8_linear_impl: quantize_act_per_token, then int8_matmul.
// out[m, n] = (float(sum_k x[m,k] * w[n,k]) * x_scale[m]) * w_scale[n]. x is
// [M, K] row-major and w is [N, K] int8 row-major (PyTorch's [out, in]): both
// K-major, the one operand form the int8 `wgmma` takes, so nothing is
// transposed. The int32 sum is exact in any order and the epilogue is two
// float32 multiplications with no addition to contract, so the result is
// bitwise that of the plain version.
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
//   * small M (decode, M = batch <= 8): bound by bytes, every weight is read
//     once (K*N bytes; the int8 weights of one 8B decode step are 7.5 GB).
//     One launch takes the one to three weights that share an x (wq, wk and
//     wv; gate and up) and the bfloat16 or float32 x itself, quantizing it
//     per row inside the kernel (`w8a8_small_mma_kernel`, below), so a
//     projection costs one launch and no elementwise kernels. A persistent
//     grid, one block an SM, each walking a contiguous range of 16-column
//     tiles across the group's matrices; the weights stream through a ring of
//     shared-memory stages by bulk copies started before x is read; the
//     products run on `mma.sync` m16n8k32 s8 with x as the 8-wide operand.
//     An int8-input mode (x already quantized, with its scales) is the same
//     kernel without the quantizing prologue; past 8 rows of x a launch runs
//     further row groups (grid.y), which read the weights again.
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

template <typename OutT>
int launch_tiled(const int8_t* x, const float* xs, const int8_t* w, const float* ws, OutT* out, int M, int N, int K,
                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, x, M, K, BM) || !make_map(&wmap, w, N, K, BN)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(w8a8_tiled_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, TILED_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  w8a8_tiled_kernel<OutT><<<grid, TILE_THREADS, TILED_SMEM, stream>>>(xmap, wmap, xs, ws, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Small-M route: one persistent launch for the projections that share an x
// ---------------------------------------------------------------------------

constexpr int SM_TILE_N = 16;  // output columns a tile: the 16 rows of mma m16n8k32's A operand
constexpr int SM_ROWS = 8;     // x rows a block takes: mma's n = 8
constexpr int SM_WARPS = 8;    // consumer warps; warp SM_WARPS is the producer
constexpr int SM_THREADS = 32 * (SM_WARPS + 1);
constexpr int SM_CONSUMERS = 32 * SM_WARPS;
constexpr int SM_MAX_MATS = 3;
constexpr int SM_XV = 16;  // 16-byte vectors of x a lane holds at once in the prologue
// A ring stage holds SM_SLAB bytes of k of the tile's 16 weight rows; the ring
// takes as many stages as fit beside x, up to SM_MAX_RING bytes. At the 8B
// model's decode shapes 1 KB slabs were within 3% of the best at M <= 4, and
// 4 KB slabs leave no room for two stages beside x at the down projection at
// M = 8 (PERF.md, scripts/w8a8_small_variants.py, which builds other values).
constexpr int SM_SLAB = 1024;
constexpr int SM_MAX_RING = 200000;
// the reduction buffer (two tiles' partial sums of every consumer warp), the
// absmax partials and the row scales; then 16 bytes of barriers a stage
constexpr int SM_FIXED = 2 * SM_WARPS * 128 * 4 + SM_WARPS * 4 + SM_ROWS * 4;
constexpr int SMEM_LIMIT = 232448;
// named barriers: 1 among the consumer warps; 2 the producer's mbarriers are ready (all warps)
constexpr int BAR_CONSUMERS = 1, BAR_READY = 2;

// Row pitches in shared memory, odd multiples of 16 bytes, so the 8 rows an
// ldmatrix phase reads fall in 8 different bank groups. x (int8): K rounded
// up to 128, plus 16. A ring stage: SM_SLAB bytes of k of 16 weight rows,
// plus 16.
__host__ __device__ __forceinline__ int x_pitch(int K) { return ((K + 127) & ~127) + 16; }
constexpr int SM_SPITCH = SM_SLAB + 16;
constexpr int SM_STAGE_BYTES = SM_TILE_N * SM_SPITCH;
__host__ __device__ __forceinline__ int small_smem(int stages, int rows, int K) {
  return stages * (SM_STAGE_BYTES + 16) + rows * x_pitch(K) + SM_FIXED;
}

struct SmallArgs {
  const void* x;         // [M, K] int8, bfloat16 or float32; row m at element m * x_stride
  long long x_stride;
  const float* x_scale;  // [M]: int8 x only
  const int8_t* w[SM_MAX_MATS];  // [N_i, K] int8
  const float* ws[SM_MAX_MATS];  // [N_i]
  void* out[SM_MAX_MATS];        // [M, N_i]
  int N[SM_MAX_MATS];
  int tiles[SM_MAX_MATS];        // ceil(N_i / SM_TILE_N)
  int nmat, M, K, stages, rows_cap, total_tiles;
};

// The m16n8k32 integer product: c (16 x 8 int32) += a (16 x 32 int8, row) b (32 x 8 int8, col).
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A weight row's bulk copy, with L2's evict-first policy: each byte is read
// once, and x and the other small operands stay.
__device__ __forceinline__ void weight_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], "
      "policy;\n"
      "}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The group's matrices as the block walks them: per-matrix values read from
// the parameters once, with constant indices, and picked by the matrix.
struct Group {
  int T0, T01;  // tiles before matrix 1, before matrix 2
  int N[SM_MAX_MATS];
  const int8_t* w[SM_MAX_MATS];
  const float* ws[SM_MAX_MATS];
  void* out[SM_MAX_MATS];
  __device__ __forceinline__ explicit Group(const SmallArgs& a) {
    T0 = a.tiles[0];
    T01 = a.nmat > 1 ? T0 + a.tiles[1] : 1 << 30;
    if (a.nmat == 1) T0 = 1 << 30;
#pragma unroll
    for (int i = 0; i < SM_MAX_MATS; ++i) {
      N[i] = a.N[i];
      w[i] = a.w[i];
      ws[i] = a.ws[i];
      out[i] = a.out[i];
    }
  }
  // tile t of the group (the tiles of each matrix in turn) -> its matrix and first column
  __device__ __forceinline__ int mat(int t) const { return (t >= T0) + (t >= T01); }
  __device__ __forceinline__ int n0(int t, int m) const { return (t - (m == 0 ? 0 : m == 1 ? T0 : T01)) * SM_TILE_N; }
  template <typename P>
  __device__ __forceinline__ static P pick(int m, P p0, P p1, P p2) { return m == 0 ? p0 : m == 1 ? p1 : p2; }
};

// The values of a 16-byte vector of x as float32 (exact for bfloat16).
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {  // bfloat16
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {  // float32
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

// A quotient's distance from the nearest half-integer below which the exact
// division decides: y = x * (1 / scale), both rounded to float32, is within
// 2^-22.9 |x / scale| <= 1.6e-5 of x / scale for |x / scale| <= 128, and
// the rounded quotient within 7.6e-6 of it; 2^-14 exceeds the sum, so
// outside it rint(y) is rint of the rounded quotient.
constexpr float SM_NEAR_HALF = 6.103515625e-05f;

// rint(x / scale) with x / scale the IEEE float32 quotient, as torch's
// division rounds it, for 4 values packed as int8 bytes in element order:
// rint of the product by the reciprocal, and the division itself only where
// a product lies near a rounding tie (within 2^-14 of k + 1/2), where the
// two might round apart. rint(y) is (y + 1.5 * 2^23) - 1.5 * 2^23 for |y| <
// 2^22 (the sum's ulp is 1, rounded half to even), and the sum's low byte is
// rint(y) as an int8: additions at the full rate, no conversion instruction.
// The plain version's clamp to [-127, 127] never binds: |x| <= absmax and
// scale >= absmax / 127 rounded down at most half an ulp, so |x / scale| <
// 127.00001. The exact path is out of line, to keep the prologue's unrolled
// code small.
constexpr float SM_ROUNDER = 12582912.f;  // 1.5 * 2^23
__device__ __noinline__ uint32_t quantize4_exact(float x0, float x1, float x2, float x3, float scale) {
  const float v[4] = {x0, x1, x2, x3};
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    word |= (static_cast<uint32_t>(__float2int_rz(rintf(__fdiv_rn(v[j], scale)))) & 0xFFu) << (8 * j);
  return word;
}
__device__ __forceinline__ uint32_t quantize4(const float* v, float scale, float inv) {
  uint32_t word = 0;
  bool near = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y = __fmul_rn(v[j], inv), t = __fadd_rn(y, SM_ROUNDER);
    near |= fabsf(__fsub_rn(y, __fsub_rn(t, SM_ROUNDER))) > 0.5f - SM_NEAR_HALF;
    word |= (__float_as_uint(t) & 0xFFu) << (8 * j);
  }
  return near ? quantize4_exact(v[0], v[1], v[2], v[3], scale) : word;
}
// the V values of a 16-byte vector of x: 8 bytes for bfloat16, 4 for float32
template <int V>
__device__ __forceinline__ auto quantize(const uint4& r, float scale, float inv) {
  float v[V];
  unpack(r, v);
  if constexpr (V == 8) return make_uint2(quantize4(v, scale, inv), quantize4(v + 4, scale, inv));
  else return quantize4(v, scale, inv);
}

// The block's x rows into shared memory as int8, and their scales. int8 x
// (XT = int8_t) is copied with the scales it came with. Otherwise each row is
// quantized as ops/quant.py::quantize_act_per_token does it: absmax = max
// |x|, scale = absmax / 127 + 1e-12 and q = clamp(rint(x / scale), -127,
// 127), IEEE divisions (see quantize4) and round-half-even in float32. Warp w
// takes row w % rows and the (w / rows)-th of the SM_WARPS / rows parts of
// its 16-byte vectors; a max is exact in any order. A lane loads up to SM_XV
// vectors at once into registers (one round trip to L2 for them all); the
// quantizing pass walks the chunks backwards, so the last chunk loaded for
// the maximum is quantized from registers: with at most SM_XV vectors a lane
// (every decode shape of the 8B model but the down projection at M > 2) x is
// read once.
template <typename XT>
__device__ __forceinline__ void stage_x(const SmallArgs& a, int m0, int rows, int8_t* xq, float* part,
                                        float* xscale, int warp, int lane) {
  constexpr int V = 16 / sizeof(XT);  // values a vector
  const int K = a.K, pitch = x_pitch(K), nvec = K / V;
  const int r = warp % rows, parts = SM_WARPS / rows, p = warp / rows;
  const int first = p * 32 + lane, step = parts * 32;
  const int mine = p < parts && first < nvec ? (nvec - first + step - 1) / step : 0;
  const int chunks = (mine + SM_XV - 1) / SM_XV;
  const uint4* xr = reinterpret_cast<const uint4*>(static_cast<const XT*>(a.x) + (m0 + r) * a.x_stride);
  int8_t* qr = xq + r * pitch;
  uint4 raw[SM_XV];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int u = 0; u < SM_XV; ++u) {
      const int j = c * SM_XV + u;
      if (j < mine) raw[u] = xr[first + j * step];
    }
  };
  if constexpr (V == 16) {
    for (int c = 0; c < chunks; ++c) {
      load_chunk(c);
#pragma unroll
      for (int u = 0; u < SM_XV; ++u) {
        const int j = c * SM_XV + u;
        if (j < mine) *reinterpret_cast<uint4*>(qr + 16 * (first + j * step)) = raw[u];
      }
    }
    if (warp == 0 && lane < rows) xscale[lane] = a.x_scale[m0 + lane];
  } else {
    float amax = 0.f;
    for (int c = 0; c < chunks; ++c) {
      load_chunk(c);
#pragma unroll
      for (int u = 0; u < SM_XV; ++u) {
        if (c * SM_XV + u < mine) {
          float v[V];
          unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) part[warp] = amax;  // 0 in a warp past the row's parts
    named_barrier(BAR_CONSUMERS, SM_CONSUMERS);
    float row_max = 0.f;
    for (int q = 0; q < parts; ++q) row_max = fmaxf(row_max, part[q * rows + r]);
    const float scale = __fadd_rn(__fdiv_rn(row_max, 127.f), 1e-12f), inv = __frcp_rn(scale);
    if (p == 0 && lane == 0) xscale[r] = scale;
    for (int c = chunks - 1; c >= 0; --c) {
      if (c != chunks - 1) load_chunk(c);
#pragma unroll
      for (int u = 0; u < SM_XV; ++u) {
        const int j = c * SM_XV + u;
        if (j < mine) {
          auto q = quantize<V>(raw[u], scale, inv);
          *reinterpret_cast<decltype(q)*>(qr + V * (first + j * step)) = q;
        }
      }
    }
  }
  // k past K up to the last 32-byte step reads zeros: the weights' bytes
  // there are stale, and zero times anything is zero
  if ((K & 31) && warp == 0 && lane < rows) *reinterpret_cast<uint4*>(xq + lane * pitch + K) = make_uint4(0, 0, 0, 0);
}

// out_i[m, n] = (float(sum_k x_q[m, k] w_i[n, k]) * x_scale[m]) * ws_i[n] for
// the block's rows m0 .. m0 + 7 and its range of column tiles.
//
// Bound by bytes: every weight byte is read once, 2 * M int8 operations a
// byte, so the tensor cores idle whatever M is. The block's range is
// contiguous over the group's tiles (16 columns of one matrix each; the
// ranges of the blocks differ by at most one tile), and it streams those
// tiles' weights through a ring of `stages` slabs (16 rows x SM_SLAB bytes
// of k) by 1-D bulk copies, one a row, on mbarriers. The producer warp sets up
// the mbarriers and starts the copies at once; the consumer warps stage x
// (quantizing it) into shared memory meanwhile, and wait for the mbarriers'
// set-up only after that. Each consumer warp takes every SM_WARPS-th 32-byte
// step of a slab: ldmatrix for the 16 x 32 weight tile and the 8 x 32 x tile
// (rows past M repeat the last one and are not stored), one mma.sync
// m16n8k32 s8, int32 sums exact in any order. At a tile's end the warps' sums
// meet in shared memory and 128 threads write the tile's outputs.
template <typename XT, typename OutT>
__global__ void __launch_bounds__(SM_THREADS, 1) w8a8_small_mma_kernel(const __grid_constant__ SmallArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = a.K, S = a.stages, pitch = x_pitch(K);
  const int m0 = blockIdx.y * SM_ROWS, rows = min(SM_ROWS, a.M - m0);
  const uint32_t ring = smem_addr(smem);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + S * SM_STAGE_BYTES);
  int* red = reinterpret_cast<int*>(smem + S * SM_STAGE_BYTES + a.rows_cap * pitch);  // [2][SM_WARPS][128]
  float* part = reinterpret_cast<float*>(red + 2 * SM_WARPS * 128);          // [SM_WARPS]
  float* xscale = part + SM_WARPS;                                           // [SM_ROWS]
  const uint32_t full = smem_addr(xscale + SM_ROWS), empty = full + 8 * S;
  // this block's tiles (total_tiles * gridDim.x < 2^31, the host checks); each in slabs of k
  const int t_begin = a.total_tiles * blockIdx.x / gridDim.x;
  const int t_end = a.total_tiles * (blockIdx.x + 1) / gridDim.x;
  const Group g(a);

  if (warp == SM_WARPS) {
    // The producer: lane 0 sets up the ring's mbarriers; then lane r copies
    // row r of each slab, after lane 0 has set the slab's bytes.
    if (lane == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, SM_WARPS);
      }
      mbar_init_fence();
    }
    __syncwarp();
    named_barrier_arrive(BAR_READY, SM_THREADS);
    for (int i = 0, t = t_begin; t < t_end; ++t) {
      const int m = g.mat(t), n0 = g.n0(t, m), nrows = min(SM_TILE_N, Group::pick(m, g.N[0], g.N[1], g.N[2]) - n0);
      const int8_t* wrow = Group::pick(m, g.w[0], g.w[1], g.w[2]) + (size_t)(n0 + lane) * K;
      for (int kb = 0; kb < K; kb += SM_SLAB, ++i) {
        const int s = i % S, bytes = min(SM_SLAB, K - kb);
        if (i >= S) mbar_wait(empty + 8 * s, (i / S + 1) & 1);
        if (lane == 0) mbar_arrive_expect_tx(full + 8 * s, nrows * bytes);
        __syncwarp();
        if (lane < nrows) weight_load(ring + s * SM_STAGE_BYTES + lane * SM_SPITCH, wrow + kb, bytes, full + 8 * s);
      }
    }
    return;
  }

  stage_x<XT>(a, m0, rows, xq, part, xscale, warp, lane);
  named_barrier(BAR_READY, SM_THREADS);  // x is staged, and the ring's mbarriers are set up

  // ldmatrix addresses: A (x4) rows (l >> 3 & 1) * 8 + (l & 7) at byte (l >> 4) * 16;
  // B (x2) row min(l & 7, rows - 1) at byte (l >> 3 & 1) * 16
  const uint32_t a_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * SM_SPITCH) + (lane >> 4) * 16;
  const uint32_t b_lane = smem_addr(xq) + min(lane & 7, rows - 1) * pitch + ((lane >> 3) & 1) * 16;
  int i = 0;
  for (int t = t_begin; t < t_end; ++t) {
    int c[4] = {0, 0, 0, 0};
    for (int kb = 0; kb < K; kb += SM_SLAB, ++i) {
      const int s = i % S, steps = (min(SM_SLAB, K - kb) + 31) / 32;
      mbar_wait(full + 8 * s, (i / S) & 1);
      const uint32_t st = ring + s * SM_STAGE_BYTES + a_lane, xk = b_lane + kb;
#pragma unroll 4
      for (int q = warp; q < steps; q += SM_WARPS) {
        uint32_t a0, a1, a2, a3, b0, b1;
        ldmatrix_x4(st + 32 * q, a0, a1, a2, a3);
        ldmatrix_x2(xk + 32 * q, b0, b1);
        mma_s8_16832(c, a0, a1, a2, a3, b0, b1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // c[e] of lane l is column n0 + l / 4 + 8 * (e >> 1), x row 2 * (l % 4) + (e & 1)
    int* rb = red + ((t - t_begin) & 1) * SM_WARPS * 128;
    *reinterpret_cast<int4*>(rb + warp * 128 + lane * 4) = make_int4(c[0], c[1], c[2], c[3]);
    named_barrier(BAR_CONSUMERS, SM_CONSUMERS);
    if (tid < 128) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < SM_WARPS; ++w) acc += rb[w * 128 + tid];
      const int mat = g.mat(t), N = Group::pick(mat, g.N[0], g.N[1], g.N[2]);
      const int l = tid >> 2, e = tid & 3;
      const int n = g.n0(t, mat) + (l >> 2) + 8 * (e >> 1), m = 2 * (l & 3) + (e & 1);
      if (m < rows && n < N)
        store_out(static_cast<OutT*>(Group::pick(mat, g.out[0], g.out[1], g.out[2])) + (size_t)(m0 + m) * N + n,
                  epilogue(acc, xscale[m], Group::pick(mat, g.ws[0], g.ws[1], g.ws[2])[n]));
    }
  }
}

template <typename XT, typename OutT>
int launch_small_kernel(const SmallArgs& a, int blocks, cudaStream_t stream) {
  static int configured = -1;  // the device the attribute was set on (a host call a launch saved)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != configured)
    err = cudaFuncSetAttribute(w8a8_small_mma_kernel<XT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = dev;
  const dim3 grid(blocks, (a.M + SM_ROWS - 1) / SM_ROWS);
  w8a8_small_mma_kernel<XT, OutT><<<grid, SM_THREADS, small_smem(a.stages, a.rows_cap, a.K), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_small(const SmallArgs& a, int out_f32, int blocks, cudaStream_t stream) {
  return out_f32 ? launch_small_kernel<XT, float>(a, blocks, stream) : launch_small_kernel<XT, bf16>(a, blocks, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The tiled route. x [M, K] int8; x_scale [M] f32; w [N, K] int8; w_scale [N]
// f32; out [M, N] bf16 (out_f32 == 0) or f32. K a multiple of 16.
int w8a8_tiled(const void* x, const void* x_scale, const void* w, const void* w_scale, void* out, int M, int N,
               int K, int out_f32, void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* xsp = static_cast<const float*>(x_scale);
  const float* wsp = static_cast<const float*>(w_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return launch_tiled<float>(xp, xsp, wp, wsp, static_cast<float*>(out), M, N, K, s);
  return launch_tiled<bf16>(xp, xsp, wp, wsp, static_cast<bf16*>(out), M, N, K, s);
}

// The small-M route: nmat (1-3) weights w_i [N_i, K] int8 with scales ws_i
// [N_i] f32 and outputs out_i [M, N_i] (bf16, or f32 when out_f32), all of one
// x [M, K] whose row m starts at element m * x_stride: x_kind 0 int8 with
// x_scale [M] f32, 1 bfloat16 and 2 float32 (quantized per row in the
// kernel). min(max_blocks, tiles) blocks over the group's 16-column tiles
// (one an SM: the caller passes the SM count), times ceil(M / 8) row groups;
// the ring takes as many stages as fit beside min(M, 8) rows of x, and the
// launch is refused if that is fewer than two. K a multiple of 16; x's rows
// 16-byte aligned.
int w8a8_small(const void* x, long long x_stride, int x_kind, const void* x_scale, int nmat, const void* w0,
               const void* w1, const void* w2, const void* s0, const void* s1, const void* s2, void* o0, void* o1,
               void* o2, int N0, int N1, int N2, int M, int K, int out_f32, int max_blocks, void* stream) {
  SmallArgs a = {};
  a.x = x;
  a.x_stride = x_stride;
  a.x_scale = static_cast<const float*>(x_scale);
  const void* ws[SM_MAX_MATS] = {w0, w1, w2};
  const void* ss[SM_MAX_MATS] = {s0, s1, s2};
  void* os[SM_MAX_MATS] = {o0, o1, o2};
  const int ns[SM_MAX_MATS] = {N0, N1, N2};
  if (nmat < 1 || nmat > SM_MAX_MATS || M <= 0 || K <= 0 || K % 16 != 0 || x_kind < 0 || x_kind > 2 ||
      (x_kind == 0 && x_scale == nullptr) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nmat = nmat;
  a.total_tiles = 0;
  for (int i = 0; i < nmat; ++i) {
    if (ns[i] <= 0 || ws[i] == nullptr || ss[i] == nullptr || os[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    a.w[i] = static_cast<const int8_t*>(ws[i]);
    a.ws[i] = static_cast<const float*>(ss[i]);
    a.out[i] = os[i];
    a.N[i] = ns[i];
    a.tiles[i] = (ns[i] + SM_TILE_N - 1) / SM_TILE_N;
    a.total_tiles += a.tiles[i];
  }
  a.M = M;
  a.K = K;
  a.rows_cap = M < SM_ROWS ? M : SM_ROWS;
  const int room = SMEM_LIMIT - small_smem(0, a.rows_cap, K);
  a.stages = (room < SM_MAX_RING ? room : SM_MAX_RING) / (SM_STAGE_BYTES + 16);
  const int blocks = max_blocks < a.total_tiles ? max_blocks : a.total_tiles;
  if (a.stages < 2 || (long long)a.total_tiles * blocks >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0) return launch_small<int8_t>(a, out_f32, blocks, s);
  if (x_kind == 1) return launch_small<bf16>(a, out_f32, blocks, s);
  return launch_small<float>(a, out_f32, blocks, s);
}

}  // extern "C"
