// Attention over the INT4 full-head cache, for Hopper (sm_90a).
//
// Replaces duo_attention_tpu/ops/flash.py::full_cache_attention_q4
// (_full_prefill_q4_kernel, _full_decode_q4_kernel,
// _OnlineSoftmax.update_q4). What is computed is attention over the
// dequantized cache, with the dequantization folded into scores and output
// and no dequantized block ever written to device memory:
//   K_t = Kq_t * ks_t + kz_t   ->  s[i,t] = (q_i . Kq_t) * ks_t + rowsum(q_i) * kz_t
//   V_t = Vq_t * vs_t + vz_t   ->  out_i  = sum_t (p[i,t] * vs_t) Vq_t + sum_t p[i,t] * vz_t
// with the TPU kernel's prefill-mode arithmetic at every S: the softmax scale
// folded into q in bf16, the nibbles (0..15, exact in bf16) multiplied on the
// tensor cores or in float32, float32 scores and statistics, p * vs_t rounded
// to bf16 before the product with the nibbles, the zero-point term in float32,
// a row with no visible key giving 0. The TPU kernel's int8 decode mode (q and
// p requantized to int8) is a workaround for its vector unit and is not
// reproduced. Cache slot j is visible to query position qpos iff j <= qpos;
// slots at or past `span` are never read.
//
// Layout: packed [B, Hkv, T/2, D] u8, byte (r, d) = q4(token 2r, d) |
// q4(token 2r+1, d) << 4; scales [B, Hkv, 4, T/2] bf16, rows (scale_even,
// scale_odd, zp_even, zp_odd).
//
// Two kernels:
//   * prefill (S > 1): one block of 4 warps per (64-query tile, query head, b),
//     as csrc/flash.cu's prefill kernel. A tile of 64 keys is 32 packed rows;
//     they are unpacked to bf16 in shared memory once per block, so Q.K^T and
//     P.V run on the tensor cores through WMMA. Bound: operations at long
//     context (4*D flops per visible pair).
//   * decode (S == 1): bound by bytes (each visible packed row read once, D
//     bytes per token for K and V together). The key range is SPLIT over
//     blockIdx.z so that B * Hkv * nsplit blocks run, not B * Hkv; each block
//     of 128 threads keeps the G query heads of its KV head as rows, scores
//     one key per thread, accumulates P.V per warp, and writes its partial
//     (sum, max, denominator, zero-point term) to scratch; a second small
//     kernel merges the partials.
//
// Lengths come from device memory ([B] int32, or one value with stride 0).
// Launches go on the caller's stream and allocate nothing (the wrapper hands
// in the decode scratch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;  // head_dim of every preset
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

struct Args {
  const bf16* q;      // [B, S, Hq, D]
  bf16* out;          // [B, S, Hq, D]
  const uint8_t* kq;  // [B, Hkv, T2, D]
  const uint8_t* vq;
  const bf16* ks;  // [B, Hkv, 4, T2]
  const bf16* vs;
  const int* cs;
  int cs_stride;
  int S, Hq, Hkv, G, T2;
  int nkeys;  // slots at or past this (the bucket) are never read
  float scale;
  float* part;  // decode scratch [B, Hkv, nsplit, G, PART]
  int nsplit, split_keys;
};

__device__ __forceinline__ float bf16_scale(float scale) {
  return __bfloat162float(__float2bfloat16(scale));
}

// Scale and zero-point of token j from a [4, T2] scale block.
__device__ __forceinline__ void token_scales(const bf16* s4, int T2, int j, float& sc, float& zp) {
  const int par = j & 1, r = j >> 1;
  sc = __bfloat162float(s4[(size_t)par * T2 + r]);
  zp = __bfloat162float(s4[(size_t)(2 + par) * T2 + r]);
}

// ---------------------------------------------------------------------------
// Prefill: WMMA tiles over keys unpacked to bf16 in shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BK = 64, NWARP = 4;
constexpr int LDK = D + 8, LDS = BK + 4, LDP = BK + 8, LDO = D + 4;
constexpr size_t PREFILL_SMEM = sizeof(bf16) * (BQ * LDK + 2 * BK * LDK + BQ * LDP) +
                                sizeof(float) * (BQ * LDS + BQ * LDO + 3 * BQ + 4 * BK);

// 16 packed bytes (16 channels of a token pair) -> 16 bf16 of the even token
// and 16 of the odd one.
__device__ __forceinline__ void unpack16(const uint4& raw, bf16* even, bf16* odd) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  __align__(16) bf16 e[16];
  __align__(16) bf16 o[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    e[u] = __float2bfloat16(static_cast<float>(b[u] & 0xF));
    o[u] = __float2bfloat16(static_cast<float>(b[u] >> 4));
  }
  reinterpret_cast<uint4*>(even)[0] = reinterpret_cast<const uint4*>(e)[0];
  reinterpret_cast<uint4*>(even)[1] = reinterpret_cast<const uint4*>(e)[1];
  reinterpret_cast<uint4*>(odd)[0] = reinterpret_cast<const uint4*>(o)[0];
  reinterpret_cast<uint4*>(odd)[1] = reinterpret_cast<const uint4*>(o)[1];
}

__global__ void __launch_bounds__(NWARP * 32) prefill_q4_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][LDK]
  bf16* sK = sQ + BQ * LDK;                   // [BK][LDK] nibbles as bf16
  bf16* sV = sK + BK * LDK;                   // [BK][LDK]
  bf16* sP = sV + BK * LDK;                   // [BQ][LDP]
  float* sS = reinterpret_cast<float*>(sP + BQ * LDP);  // [BQ][LDS]
  float* sO = sS + BQ * LDS;                  // [BQ][LDO]
  float* sM = sO + BQ * LDO;                  // [BQ]
  float* sL = sM + BQ;                        // [BQ]
  float* sZ = sL + BQ;                        // [BQ] sum of p * v zero-point
  float* sKs = sZ + BQ;                       // [BK] per-key scales of this tile
  float* sKz = sKs + BK;
  float* sVs = sKz + BK;
  float* sVz = sVs + BK;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];
  const int rows = min(BQ, a.S - q0);
  const float sc = bf16_scale(a.scale);
  const size_t bh = (size_t)b * a.Hkv + hk;
  const uint8_t* kq = a.kq + bh * a.T2 * D;
  const uint8_t* vq = a.vq + bh * a.T2 * D;
  const bf16* ks = a.ks + bh * 4 * a.T2;
  const bf16* vs = a.vs + bh * 4 * a.T2;

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
    sZ[i] = 0.f;
  }
  __syncthreads();

  // rowsum of the scaled q, for the key zero-point term; lanes 2r and 2r+1
  // share row r of the warp, as in the softmax below.
  const int my_row = warp * 16 + (lane >> 1);
  float qsum = 0.f;
  {
    const bf16* qrow = sQ + my_row * LDK + (lane & 1) * (D / 2);
    for (int d = 0; d < D / 2; ++d) qsum += __bfloat162float(qrow[d]);
    qsum += __shfl_xor_sync(0xffffffffu, qsum, 1);
  }

  const int kend = min(a.nkeys, cs + q0 + rows);  // last query position + 1

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < (BK / 2) * (D / 16); i += NWARP * 32) {
      const int pr = i / (D / 16), c = (i % (D / 16)) * 16;
      const int j = k0 + 2 * pr;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      if (j < kend) {
        kraw = *reinterpret_cast<const uint4*>(kq + (size_t)(j >> 1) * D + c);
        vraw = *reinterpret_cast<const uint4*>(vq + (size_t)(j >> 1) * D + c);
      }
      unpack16(kraw, sK + (2 * pr) * LDK + c, sK + (2 * pr + 1) * LDK + c);
      unpack16(vraw, sV + (2 * pr) * LDK + c, sV + (2 * pr + 1) * LDK + c);
    }
    if (tid < BK) {
      const int j = k0 + tid;
      float s0 = 0.f, z0 = 0.f, s1 = 0.f, z1 = 0.f;
      if (j < kend) {
        token_scales(ks, a.T2, j, s0, z0);
        token_scales(vs, a.T2, j, s1, z1);
      }
      sKs[tid] = s0;
      sKz[tid] = z0;
      sVs[tid] = s1;
      sVz[tid] = z1;
    }
    __syncthreads();

    // raw scores (q * scale) . Kq for this warp's 16 rows
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

    // Dequantize the scores, online softmax, p * v-scale to bf16.
    {
      const int r = my_row;
      const int c0 = (lane & 1) * (BK / 2);
      const int qpos = cs + q0 + r;
      float* srow = sS + r * LDS;
      float mx = NEG_INF;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int j = k0 + c;
        if (j < kend && j <= qpos) {
          const float s = srow[c] * sKs[c] + qsum * sKz[c];
          srow[c] = s;
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_next);
      float sum = 0.f, zsum = 0.f;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int j = k0 + c;
        float p = 0.f;
        if (j < kend && j <= qpos) p = expf(srow[c] - m_next);
        sum += p;
        zsum += p * sVz[c];
        sP[r * LDP + c] = __float2bfloat16(p * sVs[c]);
      }
      // Both lanes of the pair have read sM[r] before either passes this shuffle.
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      zsum += __shfl_xor_sync(0xffffffffu, zsum, 1);
      const int d0 = (lane & 1) * (D / 2);
      for (int d = d0; d < d0 + D / 2; ++d) sO[r * LDO + d] *= alpha;
      if ((lane & 1) == 0) {
        sM[r] = m_next;
        sL[r] = alpha * sL[r] + sum;
        sZ[r] = alpha * sZ[r] + zsum;
      }
    }
    __syncwarp();

    // O += (p * v-scale) Vq for this warp's 16 rows
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
      a.out[(((size_t)b * a.S + q0 + r) * a.Hq + h) * D + d] =
          __float2bfloat16((sO[r * LDO + d] + sZ[r]) / l);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode: blocks over (KV head, b, key split), then a merge
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = D;  // thread d owns output column d in the merge
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int PART = D + 4;  // per (split, query head): D sums, then max, denominator, zero-point sum

template <int G>
__global__ void __launch_bounds__(DEC_THREADS) decode_q4_kernel(Args a) {
  __shared__ float sq[G][D];
  __shared__ float sp[G][DEC_THREADS];
  __shared__ float red[G][DEC_WARPS];
  __shared__ float redz[G][DEC_WARPS];
  __shared__ float sqsum[G], sm[G], sl[G], sz[G], salpha[G];
  __shared__ float sacc[DEC_WARPS][G][D];

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];  // the query's position
  const float sc = bf16_scale(a.scale);
  const size_t bh = (size_t)b * a.Hkv + hk;
  const uint8_t* kq = a.kq + bh * a.T2 * D;
  const uint8_t* vq = a.vq + bh * a.T2 * D;
  const bf16* ks = a.ks + bh * 4 * a.T2;
  const bf16* vs = a.vs + bh * 4 * a.T2;

  for (int i = tid; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    const float qv = __bfloat162float(a.q[((size_t)b * a.Hq + hk * G + g) * D + d]);
    sq[g][d] = __bfloat162float(__float2bfloat16(qv * sc));
  }
  if (tid < G) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
    sz[tid] = 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = sq[g][tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[g][warp] = v;
  }
  __syncthreads();
  if (tid < G) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) tot += red[tid][w];
    sqsum[tid] = tot;
  }
  // P.V: warp w takes keys [32w, 32w+32) of each tile; lane owns columns 4*lane..4*lane+3.
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  const int kend = min(a.nkeys, cs + 1);
  const int lo = split * a.split_keys;  // a multiple of the tile, so pairs never straddle
  const int hi = min(kend, lo + a.split_keys);
  __syncthreads();

  for (int k0 = lo; k0 < hi; k0 += DEC_THREADS) {
    const int j = k0 + tid;
    const bool vis = j < hi;  // every slot below kend is visible to the one query
    float s[G];
    float vscale = 0.f, vzp = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = NEG_INF;
    if (vis) {
      const uint8_t* kp = kq + (size_t)(j >> 1) * D;
      const int shift = (j & 1) * 4;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; c += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kp + c);
        const uint8_t* e = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float kf = static_cast<float>((e[u] >> shift) & 0xF);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += sq[g][c + u] * kf;
        }
      }
      float kscale, kzp;
      token_scales(ks, a.T2, j, kscale, kzp);
      token_scales(vs, a.T2, j, vscale, vzp);
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = s[g] * kscale + sqsum[g] * kzp;
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
      sp[g][tid] = __bfloat162float(__float2bfloat16(p * vscale));
      float ps = p, pz = p * vzp;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
        pz += __shfl_xor_sync(0xffffffffu, pz, off);
      }
      if (lane == 0) {
        red[g][warp] = ps;
        redz[g][warp] = pz;
      }
    }
    __syncthreads();
    if (tid < G) {
      float tot = 0.f, totz = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        tot += red[tid][w];
        totz += redz[tid][w];
      }
      sl[tid] = salpha[tid] * sl[tid] + tot;
      sz[tid] = salpha[tid] * sz[tid] + totz;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= salpha[g];
    // this warp's 32 keys are 16 packed rows; keys past hi carry p = 0
    const int npair = min(16, (hi - k0 - 32 * warp + 1) / 2);
#pragma unroll 4
    for (int pr = 0; pr < npair; ++pr) {
      const int jj = 32 * warp + 2 * pr;
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(vq + (size_t)((k0 + jj) >> 1) * D + 4 * lane);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pe = sp[g][jj], po = sp[g][jj + 1];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (raw >> (8 * c)) & 0xFFu;
          acc[g][c] += pe * static_cast<float>(byte & 0xFu) + po * static_cast<float>(byte >> 4);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[warp][g][4 * lane + c] = acc[g][c];
  __syncthreads();
  float* part = a.part + ((bh * a.nsplit + split) * G) * PART;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) o += sacc[w][g][tid];
    part[g * PART + tid] = o;
  }
  if (tid < G) {
    part[tid * PART + D] = sm[tid];
    part[tid * PART + D + 1] = sl[tid];
    part[tid * PART + D + 2] = sz[tid];
  }
}

// out[b, h, :] from the splits' partials: the usual merge of online-softmax
// states, out = sum_s e^(m_s - M) (acc_s + z_s) / sum_s e^(m_s - M) l_s.
__global__ void __launch_bounds__(DEC_THREADS) merge_q4_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = h / a.G, g = h % a.G;
  const float* part = a.part + ((((size_t)b * a.Hkv + hk) * a.nsplit) * a.G + g) * PART;
  const size_t stride = (size_t)a.G * PART;
  float M = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s) M = fmaxf(M, part[s * stride + D]);
  float o = 0.f, l = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float* p = part + s * stride;
    const float w = expf(p[D] - M);
    o += w * (p[d] + p[D + 2]);
    l += w * p[D + 1];
  }
  if (l == 0.f) l = 1.f;
  a.out[((size_t)b * a.Hq + h) * D + d] = __float2bfloat16(o / l);
}

int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.S == 1) {
    const dim3 grid(a.Hkv, B, a.nsplit);
    switch (a.G) {
#define DUO_DECODE_CASE(NG) \
  case NG:                  \
    decode_q4_kernel<NG><<<grid, DEC_THREADS, 0, stream>>>(a); \
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
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_q4_kernel<<<dim3(a.Hq, B), DEC_THREADS, 0, stream>>>(a);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_q4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PREFILL_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
    prefill_q4_kernel<<<grid, NWARP * 32, PREFILL_SMEM, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Floats of decode scratch per (b, KV head, split, query head of the group).
int q4_partial_floats() { return PART; }

// q [B, S, Hq, D] bf16; k/v_packed [B, Hkv, T2, D] u8 and k/v_scales
// [B, Hkv, 4, T2] bf16 (already holding the chunk at [cs, cs+S)); cs [B] (or
// one value, cs_stride 0); out [B, S, Hq, D]. Keys at or past `span` are never
// read. Decode (S == 1): `part` is scratch of B*Hkv*nsplit*G*q4_partial_floats()
// floats and split s covers keys [s*split_keys, (s+1)*split_keys), split_keys a
// multiple of 128 with nsplit*split_keys >= span.
int full_cache_attention_q4(const void* q, const void* k_packed, const void* k_scales,
                            const void* v_packed, const void* v_scales, const void* cs,
                            int cs_stride, void* out, int B, int S, int Hq, int Hkv, int T2,
                            int span, int head_dim, float scale, void* part, int nsplit,
                            int split_keys, void* stream) {
  if (head_dim != D || Hq % Hkv != 0 || span > 2 * T2) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1 && (part == nullptr || nsplit < 1 || split_keys % DEC_THREADS != 0 ||
                 (long long)nsplit * split_keys < span))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.kq = static_cast<const uint8_t*>(k_packed);
  a.vq = static_cast<const uint8_t*>(v_packed);
  a.ks = static_cast<const bf16*>(k_scales);
  a.vs = static_cast<const bf16*>(v_scales);
  a.cs = static_cast<const int*>(cs);
  a.cs_stride = cs_stride;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.T2 = T2;
  a.nkeys = span;
  a.scale = scale;
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.split_keys = split_keys;
  return launch(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
