// In-place single-row KV-cache writes for the decode step.
//
// Replaces duo_attention_tpu/ops/inplace.py::write_row (_row_kernel) and
// ::write_streaming_rows (_stream_kernel). On the TPU these exist to keep
// XLA from re-laying-out the whole cache every step; on the card the write
// itself is the whole job: B*H rows of D bf16 values (256 bytes at D=128).
// Bound: bytes (one row read, one or two rows written per (b, head)), which
// is nanoseconds of bandwidth, so the launch itself dominates. Design: one
// block per (head, b), one 16-byte vector per thread, no shared memory.
//
// Positions come from device memory ([B] int32, or one value broadcast with
// pos_stride = 0) so the host never waits for the cache length.

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

// buf[b, h, clamp(pos[b], 0, T-1), :] = row[b, h, 0, :]
__global__ void write_row_kernel(__nv_bfloat16* buf, const __nv_bfloat16* row,
                                 const int* pos, int pos_stride, int H, int T, int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  // The clamp of duo_attention_tpu/ops/inplace.py::_as_vec(limit=T): an overrun never leaves the
  // buffer; the engine's overrun poison reports it.
  const int p = min(max(pos[b * pos_stride], 0), T - 1);
  const size_t bh = (size_t)b * H + h;
  copy_row(buf + (bh * T + p) * D, row + bh * D, D);
}

// Sink slot min(start, sink) (past the sink it lands in the never-visible
// overflow pad) and ring slot start mod R, for K and V. No clamp, as in the
// TPU kernel.
__global__ void write_streaming_rows_kernel(
    __nv_bfloat16* k_sink, __nv_bfloat16* v_sink, __nv_bfloat16* k_ring,
    __nv_bfloat16* v_ring, const __nv_bfloat16* k_row, const __nv_bfloat16* v_row,
    const int* start, int start_stride, int H, int Ts, int R, int D, int sink) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int t = start[b * start_stride];
  const int sink_slot = min(t, sink);
  const int ring_slot = pmod(t, R);
  const size_t bh = (size_t)b * H + h;
  copy_row(k_sink + (bh * Ts + sink_slot) * D, k_row + bh * D, D);
  copy_row(v_sink + (bh * Ts + sink_slot) * D, v_row + bh * D, D);
  copy_row(k_ring + (bh * R + ring_slot) * D, k_row + bh * D, D);
  copy_row(v_ring + (bh * R + ring_slot) * D, v_row + bh * D, D);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int write_row(void* buf, const void* row, const void* pos, int pos_stride, int B, int H,
              int T, int D, void* stream) {
  dim3 grid(H, B);
  write_row_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(buf), static_cast<const __nv_bfloat16*>(row),
      static_cast<const int*>(pos), pos_stride, H, T, D);
  return static_cast<int>(cudaGetLastError());
}

int write_streaming_rows(void* k_sink, void* v_sink, void* k_ring, void* v_ring,
                         const void* k_row, const void* v_row, const void* start,
                         int start_stride, int B, int H, int Ts, int R, int D, int sink,
                         void* stream) {
  dim3 grid(H, B);
  write_streaming_rows_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(k_sink), static_cast<__nv_bfloat16*>(v_sink),
      static_cast<__nv_bfloat16*>(k_ring), static_cast<__nv_bfloat16*>(v_ring),
      static_cast<const __nv_bfloat16*>(k_row), static_cast<const __nv_bfloat16*>(v_row),
      static_cast<const int*>(start), start_stride, H, Ts, R, D, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
