// Attention over the duo split KV cache, for Hopper (sm_90a).
//
// Replaces duo_attention_tpu/ops/flash.py::full_cache_attention
// (_full_prefill_kernel, _full_decode_kernel) and ::streaming_cache_attention
// (_stream_kernel, _stream_masks). What is computed is the TPU kernels'
// function, not their block schedule:
//   * softmax scale folded into q in bf16, scores in f32, NEG_INF masking,
//     online softmax in f32, p rounded to bf16 before P.V, a row with no
//     visible column gives 0 (l == 0 -> 1);
//   * full heads: cache slot j is visible to query position qpos iff
//     j <= qpos; keys past the causal frontier and past `span` (the
//     engine's bucket) are never read;
//   * streaming heads: sink slot s is visible iff s < sink and s <= qpos;
//     ring slot s holds token g = t-1 - ((t-1-s) mod R) and is visible iff
//     g >= sink, g >= max(cs-recent,0), g <= qpos and g >= 0 (t = tokens
//     after this chunk, padding included). The kernels walk the ring in
//     position order over exactly that range (key_range below), so ring
//     slots no query sees are never read.
//
// Two kernels, one per shape of work:
//   * prefill (S > 1): one block of 4 warps per (64-query tile, query head,
//     b). K/V tiles of 64 keys are staged in shared memory; Q.K^T and P.V run
//     on the tensor cores through WMMA (bf16 in, f32 accumulate); the online
//     softmax runs on two lanes per row. Bound: operations at long context
//     (4*D flops per visible (query, key) pair); WMMA from shared memory with
//     the O accumulator kept in shared memory is the simple first version.
//   * decode (S == 1): one block of 128 threads per (KV head, b); the G query
//     heads of that KV head are the rows, so K/V are read once per group.
//     Each thread scores one key of a 128-key tile; each warp accumulates
//     P.V over a quarter of the tile, four columns a lane, and the warps'
//     sums are added at the end. Bound: bytes (every visible K/V row is read
//     once); only B * H_kv blocks run, a few per layer on 132 SMs, which
//     leaves most of the card's bandwidth unused.
//
// Lengths come from device memory ([B] int32, or one value with stride 0),
// so launching never waits for the host. Launches go on the caller's stream
// and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;  // head_dim of every preset
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr int MODE_FULL = 0;
constexpr int MODE_STREAM = 1;

struct Args {
  const bf16* q;  // [B, S, Hq, D]
  bf16* out;      // [B, S, Hq, D]
  const bf16* k0;  // full: cache [B, Hkv, T0, D]; stream: sink buffer [B, Hkv, T0, D]
  const bf16* v0;
  const bf16* k1;  // stream: ring [B, Hkv, R, D]
  const bf16* v1;
  const int* cs;
  int cs_stride;
  const int* total;
  int total_stride;
  int S, Hq, Hkv, G, T0, R;
  int nkeys;  // full heads: slots at or past this (the bucket) are never read
  int sink, recent;
  float scale;
};

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The keys one block walks. Full heads: cache slots [0, end). Streaming
// heads: the sink slots [0, sink), then the ring in position order — virtual
// key sink + i is token g = glo + i, held in ring slot g mod R. A ring slot s
// holds token g(s) = t-1 - ((t-1-s) mod R), which lies in [t-R, t-1], so the
// visible ring set {s : g(s) >= sink, g(s) >= max(cs-recent, 0), g(s) <= qpos}
// is exactly the tokens g in [glo, qpos], with glo as below; the walk stops at
// the block's last query position.
struct Keys {
  int end;
  int glo;
};

template <int MODE>
__device__ __forceinline__ Keys key_range(const Args& a, int cs, int t, int qpos_max) {
  Keys k;
  if (MODE == MODE_FULL) {
    k.glo = 0;
    k.end = min(a.nkeys, qpos_max + 1);
  } else {
    k.glo = max(max(a.sink, max(cs - a.recent, 0)), t - a.R);
    k.end = a.sink + max(min(t - 1, qpos_max) - k.glo + 1, 0);
  }
  return k;
}

template <int MODE>
__device__ __forceinline__ bool visible(const Args& a, int j, int qpos, int glo) {
  if (MODE == MODE_FULL || j < a.sink) return j <= qpos;
  return glo + (j - a.sink) <= qpos;
}

template <int MODE>
__device__ __forceinline__ void kv_rows(const Args& a, int b, int hk, int j, int glo,
                                        const bf16*& kp, const bf16*& vp) {
  const size_t bh = (size_t)b * a.Hkv + hk;
  if (MODE == MODE_STREAM && j >= a.sink) {
    const size_t o = (bh * a.R + pmod(glo + j - a.sink, a.R)) * D;
    kp = a.k1 + o;
    vp = a.v1 + o;
  } else {
    const size_t o = (bh * a.T0 + j) * D;
    kp = a.k0 + o;
    vp = a.v0 + o;
  }
}

__device__ __forceinline__ float bf16_scale(float scale) {
  return __bfloat162float(__float2bfloat16(scale));
}

// ---------------------------------------------------------------------------
// Prefill: WMMA tiles
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BK = 64, NWARP = 4;
// Padded leading dimensions (keep WMMA pointers 32-byte aligned and spread
// rows over the shared-memory banks).
constexpr int LDK = D + 8, LDS = BK + 4, LDP = BK + 8, LDO = D + 4;
constexpr size_t PREFILL_SMEM =
    sizeof(bf16) * (BQ * LDK + 2 * BK * LDK + BQ * LDP) + sizeof(float) * (BQ * LDS + BQ * LDO + 2 * BQ);

template <int MODE>
__global__ void __launch_bounds__(NWARP * 32) prefill_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][LDK]
  bf16* sK = sQ + BQ * LDK;                   // [BK][LDK]
  bf16* sV = sK + BK * LDK;                   // [BK][LDK]
  bf16* sP = sV + BK * LDK;                   // [BQ][LDP]
  float* sS = reinterpret_cast<float*>(sP + BQ * LDP);  // [BQ][LDS]
  float* sO = sS + BQ * LDS;                  // [BQ][LDO]
  float* sM = sO + BQ * LDO;                  // [BQ]
  float* sL = sM + BQ;                        // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];
  const int t = MODE == MODE_STREAM ? a.total[b * a.total_stride] : 0;
  const int rows = min(BQ, a.S - q0);
  const float sc = bf16_scale(a.scale);

  for (int i = tid; i < BQ * (D / 8); i += NWARP * 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      val = *reinterpret_cast<const uint4*>(a.q + (((size_t)b * a.S + q0 + r) * a.Hq + h) * D + c);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(__bfloat162float(e[u]) * sc);
    }
    *reinterpret_cast<uint4*>(sQ + r * LDK + c) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NWARP * 32) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += NWARP * 32) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  const Keys keys = key_range<MODE>(a, cs, t, cs + q0 + rows - 1);
  const int kend = keys.end;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // sQ/sO ready; every warp is done with the previous K/V tile
    for (int i = tid; i < BK * (D / 8); i += NWARP * 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int j = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < kend) {
        const bf16 *kp, *vp;
        kv_rows<MODE>(a, b, hk, j, keys.glo, kp, vp);
        kv = *reinterpret_cast<const uint4*>(kp + c);
        vv = *reinterpret_cast<const uint4*>(vp + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LDK + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LDK + c) = vv;
    }
    __syncthreads();

    // S = (q * scale) K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * LDK + kk, LDK);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sK + n * 16 * LDK + kk, LDK);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax: lanes 2r and 2r+1 share row r of the warp, 32 columns each.
    {
      const int r = warp * 16 + (lane >> 1);
      const int c0 = (lane & 1) * (BK / 2);
      const int qpos = cs + q0 + r;
      const float* srow = sS + r * LDS;
      float mx = NEG_INF;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int j = k0 + c;
        if (j < kend && visible<MODE>(a, j, qpos, keys.glo)) mx = fmaxf(mx, srow[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_next);
      float sum = 0.f;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int j = k0 + c;
        float p = 0.f;
        if (j < kend && visible<MODE>(a, j, qpos, keys.glo)) p = expf(srow[c] - m_next);
        sum += p;
        sP[r * LDP + c] = __float2bfloat16(p);
      }
      // Both lanes of the pair have read sM[r] before either passes this shuffle.
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const int d0 = (lane & 1) * (D / 2);
      for (int d = d0; d < d0 + D / 2; ++d) sO[r * LDO + d] *= alpha;
      if ((lane & 1) == 0) {
        sM[r] = m_next;
        sL[r] = alpha * sL[r] + sum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(fp[kk], sP + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, sO + warp * 16 * LDO + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, sV + kk * 16 * LDK + n * 16, LDK);
          wmma::mma_sync(o, fp[kk], fv, o);
        }
        wmma::store_matrix_sync(sO + warp * 16 * LDO + n * 16, o, LDO, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D, d = i % D;
    if (r < rows) {
      float l = sL[r];
      if (l == 0.f) l = 1.f;
      a.out[(((size_t)b * a.S + q0 + r) * a.Hq + h) * D + d] = __float2bfloat16(sO[r * LDO + d] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode: one block per (KV head, b), the G grouped query heads as rows
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = D;  // thread d owns output column d
constexpr int DEC_WARPS = DEC_THREADS / 32;

template <int MODE, int G>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(Args a) {
  __shared__ float sq[G][D];
  __shared__ float sp[G][DEC_THREADS];
  __shared__ float red[G][DEC_WARPS];
  __shared__ float sm[G], sl[G], salpha[G];
  __shared__ float sacc[DEC_WARPS][G][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];  // the query's position
  const int t = MODE == MODE_STREAM ? a.total[b * a.total_stride] : 0;
  const float sc = bf16_scale(a.scale);

  for (int i = tid; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    const float qv = __bfloat162float(a.q[((size_t)b * a.Hq + hk * G + g) * D + d]);
    sq[g][d] = __bfloat162float(__float2bfloat16(qv * sc));
  }
  if (tid < G) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }
  // P.V: warp w takes keys [32w, 32w+32) of each tile; lane owns columns 4*lane..4*lane+3.
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  const Keys keys = key_range<MODE>(a, cs, t, cs);
  const int kend = keys.end;
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += DEC_THREADS) {
    const int j = k0 + tid;
    const bool vis = j < kend && visible<MODE>(a, j, cs, keys.glo);
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = NEG_INF;
    if (vis) {
      const bf16 *kp, *vp;
      kv_rows<MODE>(a, b, hk, j, keys.glo, kp, vp);
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kp + c);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float kf = __bfloat162float(e[u]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += sq[g][c + u] * kf;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m = s[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) red[g][warp] = m;
    }
    __syncthreads();
    if (tid < G) {
      float mx = red[tid][0];
#pragma unroll
      for (int w = 1; w < DEC_WARPS; ++w) mx = fmaxf(mx, red[tid][w]);
      const float m_prev = sm[tid], m_next = fmaxf(m_prev, mx);
      salpha[tid] = expf(m_prev - m_next);
      sm[tid] = m_next;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = vis ? expf(s[g] - sm[g]) : 0.f;
      sp[g][tid] = __bfloat162float(__float2bfloat16(p));
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) red[g][warp] = ps;
    }
    __syncthreads();
    if (tid < G) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) tot += red[tid][w];
      sl[tid] = salpha[tid] * sl[tid] + tot;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= salpha[g];
    const int jend = min(32 * warp + 32, kend - k0);
#pragma unroll 8
    for (int jj = 32 * warp; jj < jend; ++jj) {
      const bf16 *kp, *vp;
      kv_rows<MODE>(a, b, hk, k0 + jj, keys.glo, kp, vp);
      const uint2 raw = *reinterpret_cast<const uint2*>(vp + 4 * lane);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sp[g][jj];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][c] += p * __bfloat162float(e[c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[warp][g][4 * lane + c] = acc[g][c];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) o += sacc[w][g][tid];
    float l = sl[g];
    if (l == 0.f) l = 1.f;
    a.out[((size_t)b * a.Hq + hk * G + g) * D + tid] = __float2bfloat16(o / l);
  }
}

template <int MODE>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.S == 1) {
    const dim3 grid(a.Hkv, B);
    switch (a.G) {
#define DUO_DECODE_CASE(NG) \
  case NG:                  \
    decode_kernel<MODE, NG><<<grid, DEC_THREADS, 0, stream>>>(a); \
    break;
      DUO_DECODE_CASE(1)
      DUO_DECODE_CASE(2)
      DUO_DECODE_CASE(3)
      DUO_DECODE_CASE(4)
      DUO_DECODE_CASE(5)
      DUO_DECODE_CASE(6)
      DUO_DECODE_CASE(7)
      DUO_DECODE_CASE(8)
#undef DUO_DECODE_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PREFILL_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
    prefill_kernel<MODE><<<grid, NWARP * 32, PREFILL_SMEM, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// q [B, S, Hq, D]; k/v [B, Hkv, T, D] (already holding the chunk at
// [cs, cs+S)); cs [B] (or one value, cs_stride 0); out [B, S, Hq, D].
// Keys at or past `span` are never read.
int full_cache_attention(const void* q, const void* k, const void* v, const void* cs,
                         int cs_stride, void* out, int B, int S, int Hq, int Hkv, int T,
                         int span, int head_dim, float scale, void* stream) {
  if (head_dim != D || Hq % Hkv != 0 || span > T) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.k0 = static_cast<const bf16*>(k);
  a.v0 = static_cast<const bf16*>(v);
  a.cs = static_cast<const int*>(cs);
  a.cs_stride = cs_stride;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.T0 = T;
  a.nkeys = span;
  a.scale = scale;
  return launch<MODE_FULL>(a, B, static_cast<cudaStream_t>(stream));
}

// q [B, S, Hq, D]; k/v_sink [B, Hs, Ts, D]; k/v_ring [B, Hs, R, D] (already
// holding the chunk); cs and total [B] (or one value, stride 0).
int streaming_cache_attention(const void* q, const void* k_sink, const void* v_sink,
                              const void* k_ring, const void* v_ring, const void* cs,
                              int cs_stride, const void* total, int total_stride, void* out,
                              int B, int S, int Hq, int Hs, int Ts, int R, int head_dim,
                              int sink, int recent, float scale, void* stream) {
  if (head_dim != D || Hq % Hs != 0 || sink > Ts || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.k0 = static_cast<const bf16*>(k_sink);
  a.v0 = static_cast<const bf16*>(v_sink);
  a.k1 = static_cast<const bf16*>(k_ring);
  a.v1 = static_cast<const bf16*>(v_ring);
  a.cs = static_cast<const int*>(cs);
  a.cs_stride = cs_stride;
  a.total = static_cast<const int*>(total);
  a.total_stride = total_stride;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hs;
  a.G = Hq / Hs;
  a.T0 = Ts;
  a.R = R;
  a.sink = sink;
  a.recent = recent;
  a.scale = scale;
  return launch<MODE_STREAM>(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
