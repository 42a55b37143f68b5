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
//   * prefill (S > 1) is bound by operations at long context (4*D flops per
//     visible (query, key) pair, as the bf16 kernel: it reads a quarter of the
//     bytes and does the same products). It is csrc/flash.cu's prefill design
//     with an unpacking producer in front: two consumer warpgroups of 64
//     query rows run S = Q.K^T (`wgmma` m64n128k16, Q and K K-major in the
//     128-byte swizzle), the online softmax on the accumulator's registers
//     and O += P.V (`wgmma`, P from registers, V through the transpose bit);
//     O, m, l and the zero-point sum stay in registers for the whole walk,
//     S(it+1) and P.V(it) are started together, and the steady-state loop has
//     no branch around a `wgmma` or its wait. The producer warpgroup turns a
//     128-key tile (64 packed rows of 128 bytes for K and as many for V, 16 KB)
//     into bf16 nibbles written straight into the swizzled stage the
//     consumers read: 0x4300 | n is the bf16 128 + n, and one bf16x2 fma
//     subtracts 128 from two of them exactly, so a byte becomes two bf16 in
//     a few integer operations and no int-to-float conversion. Shared memory
//     decides the ring: Q is 32 KB and a bf16 K or V tile 32 KB, so three
//     bf16 stages of K and V with a packed ring beside them do not fit.
//     K and V therefore have two bf16 stages each, handed over by their own
//     `mbarrier`s: a K stage is free as soon as S of its tile is complete
//     (S lives in registers from then), a V stage when P.V is, so the
//     producer unpacks K(it+2) and V(it+1) while the consumers work on tile
//     it+1. `cp.async` keeps the packed tiles of the two tiles after the one
//     being unpacked in flight in a ring of three packed stages (16 KB each).
//     The tile's scales travel beside it as float4 (scale, scale, zp, zp of a
//     key pair: one shared load gives a thread both its columns) in a ring of
//     four; consumers apply them per accumulator column: s * ks + qsum * kz
//     before the max, p * vs before the bf16 rounding, p * vz summed per row
//     beside l. Packed rows past the frontier are zero-filled and the scales
//     of every key at or past it are 0, so a NaN in the uninitialised cache
//     never meets a 0 weight; keys are masked one by one (an odd frontier
//     splits a byte pair). 2^x on (s - m) * log2(e) replaces e^(s - m).
//     Registers: the producer keeps 72 after `setmaxnreg` and unpacks four
//     16-byte pieces at once, the consumers keep 216 (2 * 128 * 216 + 128 *
//     72 = 168 a thread at launch, the pool the block has); 40 and one piece
//     at a time was 11% slower (scripts/q4_prefill_variants.py). What still
//     holds it back: with two stages of each, the producer has one consumer
//     iteration to unpack a tile and no slack: on an H100 the walk takes 1.42
//     ms at the main path's shape, where the consumers alone (the unpack left
//     out) take 1.25-1.28 and the bf16 kernel 0.98-0.99; and, as there, a
//     warpgroup's softmax (here with the scales' two extra multiplies a score)
//     mostly follows its products.
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
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int D = 128;  // head_dim of every preset
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;

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
// Prefill: an unpacking producer and two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int NWG = 2;  // consumer warpgroups a block, 64 query rows each
constexpr int BQ = 64 * NWG, BK = 128;
constexpr int PF_THREADS = 128 * (NWG + 1);  // and one producer warpgroup that unpacks K/V
constexpr int PANEL = 64 * 128;  // 64 rows of 64 bf16 in the 128-byte swizzle
constexpr int Q_BYTES = NWG * 2 * PANEL;
constexpr int KPANEL = BK * 128;  // BK keys x 64 channels
constexpr int TILE_BYTES = 2 * KPANEL;  // a K or V tile in bf16: channel panels 0, 1
constexpr int NBUF = 2;  // bf16 stages of K, and of V
constexpr int PROWS = BK / 2;  // packed rows a tile
constexpr int PACK_BYTES = PROWS * D;  // a packed K or V tile
constexpr int NPACK = 3, LOOKAHEAD = NPACK - 1;  // packed stages; tiles in flight ahead of the unpack
constexpr int NSCALE = 4;  // scale slots: float4 (scale_even, scale_odd, zp_even, zp_odd) per pair, K then V
constexpr int SCALE_BYTES = 2 * PROWS * 16;
constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + NBUF * TILE_BYTES, P_OFF = V_OFF + NBUF * TILE_BYTES;
constexpr int S_OFF = P_OFF + NPACK * 2 * PACK_BYTES, BAR_OFF = S_OFF + NSCALE * SCALE_BYTES;
// + 4 * NBUF barriers of 8 bytes, + room to align to 1024
constexpr int PREFILL_SMEM = BAR_OFF + 4 * NBUF * 8 + 1024;
static_assert(PREFILL_SMEM <= 232448, "the block's shared memory exceeds the SM's");
constexpr uint32_t BF16X2_128 = 0x43004300u;  // (128, 128)

// Two nibbles, in bits 0-3 and 16-19 of x (other bits anything), to two bf16
// in one word: (0x4300 | n) is the bf16 128 + n, and (128 + n) * 1 - 128 is
// n, exact in one fma.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t x) {
  const uint32_t biased = (x & 0x000F000Fu) | BF16X2_128;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(biased), "r"(0x3F803F80u), "r"(0xC300C300u));
  return out;
}

// Four packed bytes (channels d..d+3 of a token pair) to the even token's
// four bf16 (two words) and the odd token's.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t& e01, uint32_t& e23, uint32_t& o01,
                                            uint32_t& o23) {
  const uint32_t b01 = __byte_perm(w, 0u, 0x4140u);  // byte 0 in bits 0-7, byte 1 in bits 16-23
  const uint32_t b23 = __byte_perm(w, 0u, 0x4342u);
  e01 = nibbles_to_bf16x2(b01);
  e23 = nibbles_to_bf16x2(b23);
  o01 = nibbles_to_bf16x2(b01 >> 4);
  o23 = nibbles_to_bf16x2(b23 >> 4);
}

__global__ void __launch_bounds__(PF_THREADS, 1) prefill_q4_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // panels need 1024-byte alignment (the swizzle pattern repeats every 1024 bytes)
  unsigned char* base = smem + ((1024u - (smem_addr(smem) & 1023u)) & 1023u);
  const uint32_t base_addr = smem_addr(base);
  // kfull/vfull[s]: the K/V tile in bf16 stage s is written (one arrival per
  // producer thread); kempty/vempty[s]: every consumer warp is done with it
  const uint32_t kfull = base_addr + BAR_OFF, kempty = kfull + 8 * NBUF;
  const uint32_t vfull = kempty + 8 * NBUF, vempty = vfull + 8 * NBUF;

  // the heaviest query tiles (the latest positions) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];
  const int rows = min(BQ, a.S - q0);
  const int kend = min(a.nkeys, cs + q0 + rows);  // last query position + 1
  const int ntiles = (kend + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NBUF; ++st) {
      mbar_init(kfull + 8 * st, 128);
      mbar_init(vfull + 8 * st, 128);
      mbar_init(kempty + 8 * st, 4 * NWG);
      mbar_init(vempty + 8 * st, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // The producer: packed tiles land by cp.async LOOKAHEAD tiles ahead; each
    // is unpacked into the bf16 stage of K, then of V, once the consumers
    // have freed it. The scales of the next tile wait in registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const int ptid = tid & 127;
    const size_t bh = (size_t)b * a.Hkv + hk;
    const uint8_t* kq = a.kq + bh * a.T2 * D;
    const uint8_t* vq = a.vq + bh * a.T2 * D;
    const unsigned short* ks = reinterpret_cast<const unsigned short*>(a.ks) + bh * 4 * a.T2;
    const unsigned short* vs = reinterpret_cast<const unsigned short*>(a.vs) + bh * 4 * a.T2;
    const int krows = (kend + 1) / 2;  // packed rows that hold a key below kend
    // packed tile t into its ring slot: 16 neighbouring bytes a thread, a
    // row of 128 bytes for 8 threads; rows at or past krows are zeros
    auto copy_packed = [&](int t) {
      if (t < ntiles) {
        const uint32_t dst = base_addr + P_OFF + (t % NPACK) * 2 * PACK_BYTES;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ptid + 128 * u, r = i >> 3, c = i & 7;
          const int pr = t * PROWS + r;
          const bool in = pr < krows;
          const size_t off = in ? (size_t)pr * D + c * 16 : 0;
          cp_async16(dst + i * 16, kq + off, in ? 16 : 0);
          cp_async16(dst + PACK_BYTES + i * 16, vq + off, in ? 16 : 0);
        }
      }
      cp_async_commit();  // an empty group past the last tile keeps the count
    };
    // the scale bits of tile t this thread carries: entries ptid and
    // ptid + 128 of the K block [4][PROWS] (row q, pair r), then of V; 0 for
    // a key at or past kend
    auto load_scales = [&](int t, uint32_t (&bits)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ptid + 128 * (u & 1), q = i / PROWS, r = i % PROWS;
        const int j = t * BK + 2 * r + (q & 1);
        const unsigned short* s4 = u < 2 ? ks : vs;
        bits[u] = (t < ntiles && j < kend) ? __ldg(s4 + (size_t)q * a.T2 + t * PROWS + r) : 0u;
      }
    };
    // one packed tile (K or V) into a bf16 stage: 16 packed bytes a step,
    // channels 16p..16p+15 of packed row r, become 16 bf16 of key 2r and of
    // key 2r + 1, two 16-byte pieces each in channel panel p / 4
    auto unpack_tile = [&](const unsigned char* src, unsigned char* dst) {
#pragma unroll 4
      for (int u = 0; u < 4; ++u) {
        const int i = ptid + 128 * u, r = i >> 3, p = i & 7;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + i * 16);
        uint4 e0, e1, o0, o1;
        unpack_word(raw.x, e0.x, e0.y, o0.x, o0.y);
        unpack_word(raw.y, e0.z, e0.w, o0.z, o0.w);
        unpack_word(raw.z, e1.x, e1.y, o1.x, o1.y);
        unpack_word(raw.w, e1.z, e1.w, o1.z, o1.w);
        unsigned char* panel = dst + (p >> 2) * KPANEL;
        const int c = (2 * p) & 7;
        *reinterpret_cast<uint4*>(panel + swz(2 * r, c)) = e0;
        *reinterpret_cast<uint4*>(panel + swz(2 * r, c + 1)) = e1;
        *reinterpret_cast<uint4*>(panel + swz(2 * r + 1, c)) = o0;
        *reinterpret_cast<uint4*>(panel + swz(2 * r + 1, c + 1)) = o1;
      }
    };

#pragma unroll 1
    for (int t = 0; t < LOOKAHEAD; ++t) copy_packed(t);
    uint32_t bits[4];
    load_scales(0, bits);
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<LOOKAHEAD - 1>();  // this thread's copies of packed tile t have landed
      // ... and every producer thread's; all are done unpacking tile t - 1, whose slot is refilled next
      asm volatile("bar.sync 3, 128;\n" ::: "memory");
      copy_packed(t + LOOKAHEAD);
      const int buf = t % NBUF;
      const unsigned char* packed = base + P_OFF + (t % NPACK) * 2 * PACK_BYTES;
      // K: the stage's previous tile has been multiplied by every consumer warp
      if (t >= NBUF) mbar_wait(kempty + 8 * buf, (t / NBUF + 1) & 1);
      unpack_tile(packed, base + K_OFF + buf * TILE_BYTES);
      // the scales go with K (the consumers' softmax reads them); their slot's
      // last reader finished before the K stage above was released
      float* sc = reinterpret_cast<float*>(base + S_OFF + (t % NSCALE) * SCALE_BYTES);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ptid + 128 * (u & 1), q = i / PROWS, r = i % PROWS;
        sc[(u >> 1) * PROWS * 4 + r * 4 + q] = __uint_as_float(bits[u] << 16);
      }
      fence_proxy_async();
      mbar_arrive(kfull + 8 * buf);
      load_scales(t + 1, bits);  // in flight under the V unpack and the next wait
      if (t >= NBUF) mbar_wait(vempty + 8 * buf, (t / NBUF + 1) & 1);
      unpack_tile(packed + PACK_BYTES, base + V_OFF + buf * TILE_BYTES);
      fence_proxy_async();
      mbar_arrive(vfull + 8 * buf);
    }
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  unsigned char* sQ = base;
  const uint32_t sQ_addr = base_addr;
  const float sc = bf16_scale(a.scale);
  // Q of this warpgroup's 64 rows, scaled in bf16, into its two swizzled panels; rows past S are zero
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int r = i >> 4, c = i & 15;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (wg * 64 + r < rows) {
      val = *reinterpret_cast<const uint4*>(a.q + (((size_t)b * a.S + q0 + wg * 64 + r) * a.Hq + h) * D + c * 8);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(__bfloat162float(e[u]) * sc);
    }
    *reinterpret_cast<uint4*>(sQ + (wg * 2 + (c >> 3)) * PANEL + swz(r, c & 7)) = val;
  }
  fence_proxy_async();  // wgmma may read what was stored
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's own barrier

  // This thread's two rows of its warpgroup's 64: r0 and r0 + 8. In a
  // 64 x N accumulator, element 4j + e lies in row r0 + 8 * (e >> 1) and
  // column 8j + 2 * (lane & 3) + (e & 1).
  const int r0 = warp * 16 + (lane >> 2);
  const int qrow0 = q0 + wg * 64 + r0;  // row in the chunk
  const int qpos0 = cs + qrow0;
  const int wg_qmin = cs + q0 + wg * 64, wg_qmax = wg_qmin + 63;
  const int cq = 2 * (lane & 3);
  // rowsum of the scaled q of rows r0 and r0 + 8 (the key zero-point's
  // weight): each lane of the quad sums 32 channels, then the quad
  float qs0 = 0.f, qs1 = 0.f;
#pragma unroll
  for (int pc = 0; pc < 4; ++pc) {
    const int c = (lane & 3) * 4 + pc;  // 8-channel piece 0..15
    const unsigned char* panel = sQ + (wg * 2 + (c >> 3)) * PANEL;
    const uint4 v0 = *reinterpret_cast<const uint4*>(panel + swz(r0, c & 7));
    const uint4 v1 = *reinterpret_cast<const uint4*>(panel + swz(r0 + 8, c & 7));
    const bf16* e0 = reinterpret_cast<const bf16*>(&v0);
    const bf16* e1 = reinterpret_cast<const bf16*>(&v1);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      qs0 += __bfloat162float(e0[u]);
      qs1 += __bfloat162float(e1[u]);
    }
  }
  qs0 += __shfl_xor_sync(0xffffffffu, qs0, 1);
  qs0 += __shfl_xor_sync(0xffffffffu, qs0, 2);
  qs1 += __shfl_xor_sync(0xffffffffu, qs1, 1);
  qs1 += __shfl_xor_sync(0xffffffffu, qs1, 2);
  // the tiles this warpgroup multiplies: those that hold a key one of its rows
  // sees (the first n_wg); it still waits for the rest and releases them
  const int n_wg = min(ntiles, (wg_qmax + BK) / BK);

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // l: this thread's share of the row sum; z: of the row's zero-point sum p . vz
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, z0 = 0.f, z1 = 0.f;
  float s[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = 0u;

  const uint64_t dq0 = make_desc(sQ_addr + wg * 2 * PANEL, 16, 1024);
  // S = (q * scale) Kq^T of one tile: 8 steps of 16 channels; a step is 32
  // bytes inside a panel's 128-byte rows, and the second panel follows the first
  auto start_qk = [&](int tile) {
    const uint64_t dk0 = make_desc(base_addr + K_OFF + (tile % NBUF) * TILE_BYTES, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t oq = (uint64_t)(((kk >> 2) * PANEL + (kk & 3) * 32) >> 4);
      const uint64_t ok = (uint64_t)(((kk >> 2) * KPANEL + (kk & 3) * 32) >> 4);
      wgmma_m64n128k16_ss(s, dq0 + oq, dk0 + ok, kk > 0);
    }
    wgmma_commit();
  };
  // O += (P * vs) Vq of one tile: 8 steps of 16 keys; a step is 16 rows of 128 bytes in each V panel
  auto start_pv = [&](int tile) {
    const uint64_t dv0 = make_desc(base_addr + V_OFF + (tile % NBUF) * TILE_BYTES, KPANEL, 1024);
    fence_regs(p);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_m64n128k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                          dv0 + (uint64_t)((kk * 16 * 128) >> 4));
    }
    wgmma_commit();
  };
  float al0 = 1.f, al1 = 1.f;
  // The online softmax of the tile in s, in place: the scores dequantized,
  // masks, the new row maxima, the scales of what came before (al0, al1),
  // e^(s - m) in f32, the row sums l and p . vz; s becomes p * vs.
  auto softmax = [&](int tile) {
    const int k0 = tile * BK;
    const float4* sck = reinterpret_cast<const float4*>(base + S_OFF + (tile % NSCALE) * SCALE_BYTES);
    const float4* scv = sck + PROWS;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {  // columns 8jn + cq and + 1: key pair 4jn + cq / 2
      const float4 k4 = sck[4 * jn + (cq >> 1)];
      s[4 * jn] = fmaf(s[4 * jn], k4.x, qs0 * k4.z);
      s[4 * jn + 1] = fmaf(s[4 * jn + 1], k4.y, qs0 * k4.w);
      s[4 * jn + 2] = fmaf(s[4 * jn + 2], k4.x, qs1 * k4.z);
      s[4 * jn + 3] = fmaf(s[4 * jn + 3], k4.y, qs1 * k4.w);
    }
    // masks only where they bite: the diagonal and the ragged end; per key
    // (an odd frontier splits a byte pair)
    const bool masked = k0 + BK > kend || k0 + BK - 1 > wg_qmin;
    if (masked) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int j = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qpos = qpos0 + 8 * ((i >> 1) & 1);
        if (!(j < kend && j <= qpos)) s[i] = NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // the difference first: NEG_INF - NEG_INF is 0, and NEG_INF * LOG2E would be -inf
    al0 = fast_exp2((m0 - mn0) * LOG2E);
    al1 = fast_exp2((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
    float sum0 = 0.f, sum1 = 0.f, zs0 = 0.f, zs1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int i = 4 * jn;
      float p0 = fast_exp2(fmaf(s[i], LOG2E, -ml0)), p1 = fast_exp2(fmaf(s[i + 1], LOG2E, -ml0));
      float p2 = fast_exp2(fmaf(s[i + 2], LOG2E, -ml1)), p3 = fast_exp2(fmaf(s[i + 3], LOG2E, -ml1));
      if (masked) {  // a masked score is exactly NEG_INF; its row's max may be NEG_INF too
        p0 = s[i] == NEG_INF ? 0.f : p0;
        p1 = s[i + 1] == NEG_INF ? 0.f : p1;
        p2 = s[i + 2] == NEG_INF ? 0.f : p2;
        p3 = s[i + 3] == NEG_INF ? 0.f : p3;
      }
      const float4 v4 = scv[4 * jn + (cq >> 1)];
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      zs0 = fmaf(p0, v4.z, fmaf(p1, v4.w, zs0));
      zs1 = fmaf(p2, v4.z, fmaf(p3, v4.w, zs1));
      s[i] = p0 * v4.x;
      s[i + 1] = p1 * v4.y;
      s[i + 2] = p2 * v4.x;
      s[i + 3] = p3 * v4.y;
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    z0 = al0 * z0 + zs0;
    z1 = al1 * z1 + zs1;
  };
  // With the product that read p and wrote o complete: scale o, round s to bf16 into p
  // (the A fragment of k-step kk: a0, a1 from column group 2kk, a2, a3 from 2kk + 1).
  auto rescale_and_pack = [&]() {
    fence_regs(p);
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      o[i] *= al0;
      o[i + 1] *= al0;
      o[i + 2] *= al1;
      o[i + 3] *= al1;
    }
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      p[(i >> 3) * 4 + ((i >> 2) & 1) * 2] = pack_bf16(s[i], s[i + 1]);
      p[(i >> 3) * 4 + ((i >> 2) & 1) * 2 + 1] = pack_bf16(s[i + 2], s[i + 3]);
    }
  };

  // tile `tile`'s K (and scales), or V, is in its stage, and wgmma may read it
  auto wait_k = [&](int tile) {
    mbar_wait(kfull + 8 * (tile % NBUF), (tile / NBUF) & 1);
    fence_proxy_async();
  };
  auto wait_v = [&](int tile) {
    mbar_wait(vfull + 8 * (tile % NBUF), (tile / NBUF) & 1);
    fence_proxy_async();
  };
  // this warp is done with the stage
  auto release_k = [&](int tile) {
    if (lane == 0) mbar_arrive(kempty + 8 * (tile % NBUF));
  };
  auto release_v = [&](int tile) {
    if (lane == 0) mbar_arrive(vempty + 8 * (tile % NBUF));
  };

  // The walk, as in csrc/flash.cu: S of tile it+1 and P.V of tile it are
  // started together, and the softmax of tile it+1 runs under P.V of tile
  // it. A K stage is released once S of its tile is complete, a V stage
  // once P.V is.
  if (0 < n_wg) {
    wait_k(0);
    start_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    release_k(0);
    softmax(0);
    rescale_and_pack();
    // (the steady state has no branch around a product or its wait: the
    // assembler gives up overlapping them otherwise)
    for (int it = 0; it < n_wg - 1; ++it) {
      wait_k(it + 1);
      wait_v(it);
      start_qk(it + 1);
      start_pv(it);
      wgmma_wait<1>();  // S(it+1) is complete; P.V(it) runs on
      fence_regs(s);
      release_k(it + 1);
      softmax(it + 1);
      fence_regs(s);  // the exponentials are taken before the wait below, under P.V(it), not after it
      wgmma_wait<0>();
      release_v(it);
      rescale_and_pack();
    }
    const int last = n_wg - 1;
    wait_v(last);
    start_pv(last);
    wgmma_wait<0>();
    release_v(last);
  }
  // tiles wholly above this warpgroup's rows: waited for and released, as the barriers count
  for (int it = n_wg; it < ntiles; ++it) {
    wait_k(it);
    release_k(it);
    wait_v(it);
    release_v(it);
  }
  fence_regs(o);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  z0 += __shfl_xor_sync(0xffffffffu, z0, 1);
  z0 += __shfl_xor_sync(0xffffffffu, z0, 2);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 1);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qrow0 + 8 * half;
    if (row < a.S) {
      bf16* dst = a.out + (((size_t)b * a.S + row) * a.Hq + h) * D + cq;
      const float inv = half ? inv1 : inv0, z = half ? z1 : z0;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<uint32_t*>(dst + 8 * jn) =
            pack_bf16((o[4 * jn + 2 * half] + z) * inv, (o[4 * jn + 2 * half + 1] + z) * inv);
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
        prefill_q4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PREFILL_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
    prefill_q4_kernel<<<grid, PF_THREADS, PREFILL_SMEM, stream>>>(a);
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
