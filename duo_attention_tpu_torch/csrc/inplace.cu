// In-place single-row KV-cache writes for the decode step.
//
// Replaces duo_attention_tpu/ops/inplace.py::write_row (_row_kernel),
// ::write_streaming_rows (_stream_kernel) and ::write_q4_token (_q4_kernel,
// with the quantization its caller does in XLA). On the TPU these exist to keep
// XLA from re-laying-out the whole cache every step; on the card the write
// itself is the whole job: B*H rows of D bf16 values (256 bytes at D=128).
// Bound: bytes (one row read, one or two rows written per (b, head)), which
// is nanoseconds of bandwidth, so the launch itself dominates. Design: one
// 16-byte vector per thread, no shared memory; write_row one block per
// (head, b), write_streaming_rows one block for the layer's rows.
// write_row takes a layer's K row and V row of the full heads in one launch
// (16 pieces of 16 bytes each at D = 128: one warp), and reads them in place
// from the projection's [B, 1, Hkv, D] output by their strides, so the decode
// step makes no copy before it; so does write_streaming_rows, for the
// streaming heads' K and V rows.
//
// Positions come from device memory ([B] int32, or one value broadcast with
// pos_stride = 0) so the host never waits for the cache length.
//
// write_q4_token quantizes and writes in the same kernel: one warp per
// (head, b) and row reads the bf16 row (4 values a lane per 128 channels),
// takes min and max by shuffles, computes the nibbles from the float32 scale
// with IEEE division and round-half-even, merges them into the pair-row's
// bytes keeping the partner token's nibble, and stores scale and zero-point
// rounded to bf16. Bound: bytes (D*2 read, D read and written, 4 written per
// (b, head) and row). Like write_row it takes a layer's K row and V row in
// one launch (a second warp for V), read in place by their strides from the
// projection's output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ void copy_row(__nv_bfloat16* dst, const __nv_bfloat16* src, int D) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < D / 8; i += blockDim.x) d[i] = s[i];
}

// k_buf[b, h, clamp(pos[b], 0, T-1), :] = k_row[b, h, :] and, when v_buf is
// not null, the same of v_buf and v_row. Row (b, h) starts at element
// b * row_sb + h * row_sh of k_row and of v_row; its D channels are contiguous.
__global__ void write_row_kernel(__nv_bfloat16* k_buf, __nv_bfloat16* v_buf, const __nv_bfloat16* k_row,
                                 const __nv_bfloat16* v_row, long long row_sb, long long row_sh,
                                 const int* pos, int pos_stride, int H, int T, int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  // The clamp of duo_attention_tpu/ops/inplace.py::_as_vec(limit=T): an overrun never leaves the
  // buffer; the engine's overrun poison reports it.
  const int p = min(max(pos[b * pos_stride], 0), T - 1);
  const size_t dst = (((size_t)b * H + h) * T + p) * D;
  const long long src = b * row_sb + h * row_sh;
  const int pieces = D / 8, n = v_buf ? 2 * pieces : pieces;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool v = i >= pieces;
    const int c = 8 * (v ? i - pieces : i);
    *reinterpret_cast<uint4*>((v ? v_buf : k_buf) + dst + c) =
        *reinterpret_cast<const uint4*>((v ? v_row : k_row) + src + c);
  }
}

// Sink slot min(start, sink) (past the sink it lands in the never-visible
// overflow pad) and ring slot start mod R, for K and V. No clamp, as in the
// TPU kernel. The whole layer in one launch: thread i copies 16-byte piece i
// of (b, head, K or V, piece) to both slots, so adjacent threads read and
// write adjacent bytes of a row; row (b, h) of k_row and of v_row starts at
// element b * row_sb + h * row_sh (in place in the projection's output).
__global__ void write_streaming_rows_kernel(
    __nv_bfloat16* k_sink, __nv_bfloat16* v_sink, __nv_bfloat16* k_ring,
    __nv_bfloat16* v_ring, const __nv_bfloat16* k_row, const __nv_bfloat16* v_row,
    long long row_sb, long long row_sh, const int* start, int start_stride, int B, int H, int Ts, int R,
    int D, int sink) {
  const int pieces = D / 8, total = B * H * 2 * pieces;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c = 8 * (i % pieces), row = i / pieces, v = row & 1, bh = row >> 1, b = bh / H, h = bh % H;
    const int t = start[b * start_stride];
    const uint4 val = *reinterpret_cast<const uint4*>((v ? v_row : k_row) + b * row_sb + h * row_sh + c);
    *reinterpret_cast<uint4*>((v ? v_sink : k_sink) + ((size_t)bh * Ts + min(t, sink)) * D + c) = val;
    *reinterpret_cast<uint4*>((v ? v_ring : k_ring) + ((size_t)bh * R + pmod(t, R)) * D + c) = val;
  }
}

// INT4 token write. bq [B, H, T2, D] u8: byte (r, d) = q4(token 2r, d) |
// q4(token 2r+1, d) << 4. bs [B, H, 4, T2] bf16: rows (scale_even, scale_odd,
// zp_even, zp_odd). Row (b, h) of D bf16 starts at element b * row_sb + h *
// row_sh of row. Warp 1, when the block has two, writes v_row into (v_bq,
// v_bs) the same way. The position is clamped into [0, 2*T2 - 1], the clamp
// of duo_attention_tpu/ops/inplace.py::_as_vec(limit=2*T2).
// scale = (max - min) / 15 + 1e-8 and q = clip(rint((x - min) / scale), 0, 15)
// in float32, exactly ops/quant.py::quantize_int4_nibbles (no mul-add pair
// for the compiler to contract).
__global__ void write_q4_token_kernel(uint8_t* k_bq, __nv_bfloat16* k_bs, const __nv_bfloat16* k_row,
                                      uint8_t* v_bq, __nv_bfloat16* v_bs, const __nv_bfloat16* v_row,
                                      long long row_sb, long long row_sh, const int* pos, int pos_stride, int H,
                                      int T2, int D) {
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x & 31;
  const bool v = threadIdx.x >= 32;
  uint8_t* bq = v ? v_bq : k_bq;
  __nv_bfloat16* bs = v ? v_bs : k_bs;
  const int t = min(max(pos[b * pos_stride], 0), 2 * T2 - 1);
  const int par = t & 1, r = t >> 1;
  const size_t bh = (size_t)b * H + h;
  const __nv_bfloat16* src = (v ? v_row : k_row) + b * row_sb + h * row_sh;

  float mn = 3.402823466e38f, mx = -3.402823466e38f;
  for (int d = lane * 4; d < D; d += 128) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src + d);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x = __bfloat162float(e[u]);
      mn = fminf(mn, x);
      mx = fmaxf(mx, x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const float scale = __fadd_rn(__fdiv_rn(__fsub_rn(mx, mn), 15.0f), 1e-8f);

  uint8_t* dst = bq + (bh * T2 + r) * D;
  const uint32_t keep = par ? 0x0F0F0F0Fu : 0xF0F0F0F0u;
  for (int d = lane * 4; d < D; d += 128) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src + d);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint32_t nib = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float q = rintf(__fdiv_rn(__fsub_rn(__bfloat162float(e[u]), mn), scale));
      nib |= static_cast<uint32_t>(fminf(fmaxf(q, 0.f), 15.f)) << (8 * u);
    }
    uint32_t* word = reinterpret_cast<uint32_t*>(dst + d);
    *word = (*word & keep) | (nib << (4 * par));
  }
  if (lane == 0) {
    __nv_bfloat16* s4 = bs + bh * 4 * T2;
    s4[(size_t)par * T2 + r] = __float2bfloat16(scale);
    s4[(size_t)(2 + par) * T2 + r] = __float2bfloat16(mn);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// k_buf, v_buf [B, H, T, D] (v_buf null: K only); rows [B, H, 1, D] at strides
// row_sb, row_sh (elements, multiples of 8; both rows alike).
int write_row(void* k_buf, void* v_buf, const void* k_row, const void* v_row, long long row_sb,
              long long row_sh, const void* pos, int pos_stride, int B, int H, int T, int D,
              void* stream) {
  if (D % 8 != 0 || row_sb % 8 != 0 || row_sh % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H, B);
  write_row_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(k_buf), static_cast<__nv_bfloat16*>(v_buf),
      static_cast<const __nv_bfloat16*>(k_row), static_cast<const __nv_bfloat16*>(v_row), row_sb, row_sh,
      static_cast<const int*>(pos), pos_stride, H, T, D);
  return static_cast<int>(cudaGetLastError());
}

// k_sink, v_sink [B, H, Ts, D]; k_ring, v_ring [B, H, R, D]; rows [B, H, 1, D]
// at strides row_sb, row_sh (elements, multiples of 8; both rows alike).
int write_streaming_rows(void* k_sink, void* v_sink, void* k_ring, void* v_ring, const void* k_row,
                         const void* v_row, long long row_sb, long long row_sh, const void* start, int start_stride,
                         int B, int H, int Ts, int R, int D, int sink, void* stream) {
  if (D % 8 != 0 || row_sb % 8 != 0 || row_sh % 8 != 0 || B <= 0 || H <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // one block for a decode layer's rows (16 threads a 256-byte row)
  const int total = B * H * 2 * (D / 8), threads = total < 1024 ? (total + 31) / 32 * 32 : 1024;
  write_streaming_rows_kernel<<<(total + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(k_sink), static_cast<__nv_bfloat16*>(v_sink),
      static_cast<__nv_bfloat16*>(k_ring), static_cast<__nv_bfloat16*>(v_ring),
      static_cast<const __nv_bfloat16*>(k_row), static_cast<const __nv_bfloat16*>(v_row), row_sb, row_sh,
      static_cast<const int*>(start), start_stride, B, H, Ts, R, D, sink);
  return static_cast<int>(cudaGetLastError());
}

// k_bq/v_bq [B, H, T2, D] u8, k_bs/v_bs [B, H, 4, T2] bf16 (v_bq null: K
// only); rows [B, H, 1, D] at strides row_sb, row_sh (elements, multiples of
// 4; both rows alike).
int write_q4_token(void* k_bq, void* k_bs, const void* k_row, void* v_bq, void* v_bs, const void* v_row,
                   long long row_sb, long long row_sh, const void* pos, int pos_stride, int B, int H, int T2,
                   int D, void* stream) {
  if (D % 128 != 0 || T2 <= 0 || row_sb % 4 != 0 || row_sh % 4 != 0 ||
      (v_bq != nullptr && (v_bs == nullptr || v_row == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H, B);
  write_q4_token_kernel<<<grid, v_bq ? 64 : 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(k_bq), static_cast<__nv_bfloat16*>(k_bs), static_cast<const __nv_bfloat16*>(k_row),
      static_cast<uint8_t*>(v_bq), static_cast<__nv_bfloat16*>(v_bs), static_cast<const __nv_bfloat16*>(v_row),
      row_sb, row_sh, static_cast<const int*>(pos), pos_stride, H, T2, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
