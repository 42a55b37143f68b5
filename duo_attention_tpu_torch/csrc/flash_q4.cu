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
//     bytes per token for K and V together, and 8 bytes of scales), so the
//     design is about keeping enough bytes in flight. One launch: the key
//     range of each (b, KV head) is SPLIT over blocks by a plan made from the
//     bucket (ops/flash.py::q4_decode_split_plan: one 256-thread block an SM,
//     as many as its 146 registers a thread allow, and at most 32 splits of a
//     (b, KV head)), and each block's eight warps take 32 keys (16 pair rows)
//     of every 256-key tile of the split. A warp owns its slice outright: it
//     copies the slice's packed K and V rows and their scales into a 3-stage
//     ring of its own by `cp.async` (two slices, 8.5 KB, in flight while it
//     works on one; 70 KB a block), so no barrier is needed in the walk, only
//     `__syncwarp`. The copies go out before the frontier and q are read. It
//     reads each pair row once: one 32-bit word gives both keys' nibbles as
//     bf16 (the prefill producer's `0x4300 | n` and one `fma.rn.bf16x2`), and
//     S = Q K^T and O += P V run on the tensor cores as `mma.sync` m16n8k16
//     with the group's G <= 8 query rows padded to 16 (the channel and key orders are renumbered so that fragments come
//     straight from the words; see decode_q4_kernel). Scores and the online
//     softmax are per warp, over its own keys, with quad shuffles; the eight
//     warps merge once at the end of the block. The block writes its partial
//     (sum, max, denominator, zero-point term), fences, and takes a ticket
//     from its (b, KV head)'s counter; the last block merges the at most 32
//     partials (with the arithmetic of the former merge kernel; float4 loads,
//     all independent) into the output and takes the counter back to 0 for
//     the next launch. Splits past the frontier return at once.
//
// Lengths come from device memory ([B] int32, or one value with stride 0).
// Launches go on the caller's stream and allocate nothing (the wrapper hands
// in the decode scratch and the ticket counters, both kept across calls).

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
  int* counters;  // decode tickets [B, Hkv], 0 between launches
  int nsplit, split_keys;
};

__device__ __forceinline__ float bf16_scale(float scale) {
  return __bfloat162float(__float2bfloat16(scale));
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
// Decode: one launch over (key split, KV head, b); the last block of a
// (b, KV head) to finish merges its splits
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_TILE = 32 * DEC_WARPS;  // keys a block steps over: 32 (16 pair rows) for each warp
constexpr int WROWS = 16;  // pair rows a warp takes from each tile
constexpr int DEC_STAGES = 3;  // slices in a warp's ring: all but one in flight
constexpr int WSCALE_BYTES = 4 * WROWS * 2;  // [4][WROWS] bf16: scale_e, scale_o, zp_e, zp_o
constexpr int WSTAGE = 2 * WROWS * D + 2 * WSCALE_BYTES;  // K rows, V rows, K scales, V scales
constexpr int DEC_SMEM = DEC_WARPS * DEC_STAGES * WSTAGE;
constexpr int DEC_MAX_SPLITS = 32;  // splits a (b, KV head): the merge gives each partial a lane
constexpr int MERGE_CHUNK = 16;  // partials' sums a merging thread holds in registers at once
constexpr int DEC_MAX_G = 8;  // the query rows of an m16n8k16 tile that hold a head (8-15 are zero)
constexpr int PART = D + 4;  // per (split, query head): D sums, then the max, denominator, zero-point sum
// The block's merge of its warps reuses the ring: acc [warp][row][ACC_ROW], a
// row in four segments of 32 channels at ACC_SEG apart, so that the 32 lanes
// of a warp, (row gid, channel 32t + j), store to 32 banks (gid + 8t + j).
constexpr int ACC_SEG = 40, ACC_ROW = 4 * ACC_SEG + 1;
constexpr int WACC_FLOATS = DEC_WARPS * DEC_MAX_G * ACC_ROW;
static_assert(DEC_THREADS % D == 0, "the block's merge gives each thread one column");
static_assert(4 * (WACC_FLOATS + 3 * DEC_WARPS * DEC_MAX_G) <= DEC_SMEM, "the warps' merge exceeds the ring");
static_assert(4 * (2 * DEC_MAX_SPLITS * DEC_MAX_G + 2 * DEC_MAX_G) <= DEC_SMEM, "the splits' merge exceeds the ring");
static_assert(DEC_MAX_SPLITS <= 32, "the merge gives each partial a lane");

// Byte I of word w (w4 = w >> 4) to the bf16 pair (low nibble, high nibble).
template <int I>
__device__ __forceinline__ uint32_t byte_to_bf16x2(uint32_t w, uint32_t w4) {
  return nibbles_to_bf16x2(__byte_perm(w, w4, I | ((4 + I) << 8)));
}

// Takes a ticket: the counter's value before adding 1, release and acquire at
// the device's scope. Taken by one thread between two barriers, it publishes
// the block's writes before it and makes the writes of the blocks that took
// earlier tickets visible to the block after it (the idiom of CUTLASS's
// generic barrier).
__device__ __forceinline__ int ticket_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// The former merge kernel's arithmetic over n <= DEC_MAX_SPLITS partials at p
// (G * PART floats apart), into the G output rows: out = sum_s w_s (acc_s +
// z_s) / sum_s w_s l_s, with w_s = e^(m_s - M), M = max_s m_s (a row whose sum
// of l is 0 gives 0).
__device__ void merge_partials(const float* p, int n, int G, float* smem, bf16* out) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* sw = smem;  // [s][row]: w_s
  float* sz = sw + DEC_MAX_SPLITS * DEC_MAX_G;  // [s][row]: z_s
  float* sl = sz + DEC_MAX_SPLITS * DEC_MAX_G;  // [row]: sum_s w_s l_s
  // the first MERGE_CHUNK sums of this thread's row go out with the statistics' loads
  const int c4 = 4 * (tid & 31);
  float4 x[MERGE_CHUNK];
  auto load_chunk = [&](int g, int s0) {
#pragma unroll
    for (int u = 0; u < MERGE_CHUNK; ++u)
      x[u] = g < G && s0 + u < n ? __ldcg(reinterpret_cast<const float4*>(p + ((s0 + u) * G + g) * PART + c4))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  load_chunk(tid >> 5, 0);
  for (int g = warp; g < G; g += DEC_WARPS) {
    const float* q = p + (lane * G + g) * PART;  // lane s reads partial s
    const bool in = lane < n;
    const float m = in ? __ldcg(q + D) : NEG_INF, l = in ? __ldcg(q + D + 1) : 0.f, zs = in ? __ldcg(q + D + 2) : 0.f;
    float M = m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float w = in ? fast_exp2((m - M) * LOG2E) : 0.f;
    sw[lane * DEC_MAX_G + g] = w;
    sz[lane * DEC_MAX_G + g] = zs;
    float L = w * l;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) sl[g] = L;
  }
  __syncthreads();
  // thread: row tid / 32 (and + DEC_WARPS), columns 4 (tid % 32) .. + 3
  for (int pass = 0; pass < (G + DEC_WARPS - 1) / DEC_WARPS; ++pass) {
    const int g = (tid >> 5) + DEC_WARPS * pass;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n; s0 += MERGE_CHUNK) {
      if (pass > 0 || s0 > 0) load_chunk(g, s0);
#pragma unroll
      for (int u = 0; u < MERGE_CHUNK; ++u) {
        if (s0 + u >= n || g >= G) break;
        const float w = sw[(s0 + u) * DEC_MAX_G + g], zs = sz[(s0 + u) * DEC_MAX_G + g];
        acc.x += w * (x[u].x + zs);
        acc.y += w * (x[u].y + zs);
        acc.z += w * (x[u].z + zs);
        acc.w += w * (x[u].w + zs);
      }
    }
    if (g >= G) continue;
    const float L = sl[g] == 0.f ? 1.f : sl[g];
    *reinterpret_cast<uint2*>(out + g * D + c4) =
        make_uint2(pack_bf16(acc.x / L, acc.y / L), pack_bf16(acc.z / L, acc.w / L));
  }
}

#ifdef DUO_Q4_DECODE_FMA
// The same products by float32 FMAs on the CUDA cores, for the measurement
// that chose the tensor cores (chip_smoke.py phase 3 builds both). A nibble n
// becomes float32 exactly as the bits 0x4B000000 | n less 2^23.
__device__ __forceinline__ float nib_f32(uint32_t n) { return __uint_as_float(0x4B000000u | n) - 8388608.f; }
#endif

// The walk keeps, per warp, the online softmax of query row gid over the
// warp's own keys: 32 keys (16 pair rows) of every DEC_TILE-key tile of the split.
// Per slice, in two groups of 8 pair rows:
//   S = Q K^T by m16n8k16 with the channels renumbered so that a thread's B
//     fragment is one 32-bit word of its pair row: k-step ks of thread t is
//     channels 32t + 4ks + {0,1} (k 2t, 2t + 1) and + {2,3} (k 2t + 8, 2t + 9);
//     one word gives the even key's fragment (n-tile "even") and the odd
//     key's (n-tile "odd"), so column n of either is the group's pair row n;
//   O += P V by m16n8k16 with the keys renumbered so that k 2t, 2t + 1 are
//     pair row 2t's two keys and k 2t + 8, 2t + 9 pair row 2t + 1's: the S
//     fragments are P's A fragment as they stand, and a B register is one
//     byte (both keys' nibbles) of one channel: channel 16 gid + j of n-tile j,
//     so a thread's 16 bytes of a pair row feed all 16 n-tiles, and its output
//     columns are channels 32t + j and 32t + 16 + j.
__global__ void __launch_bounds__(DEC_THREADS) decode_q4_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  const int G = a.G;
  const int lo = split * a.split_keys;  // a multiple of the tile: pair rows never straddle splits
  const int hi_split = min(a.nkeys, lo + a.split_keys);  // the split's keys inside the span
  const size_t bh = (size_t)b * a.Hkv + hk;
  bf16* out = a.out + ((size_t)b * a.Hq + hk * G) * D;  // the group's G rows

  // The warp's ring: stage = 16 packed K rows, 16 V rows (both in the 128-byte
  // swizzle: the 16-byte piece c of row r at c ^ (r & 7)), then their scales.
  unsigned char* ring = dsmem + warp * DEC_STAGES * WSTAGE;
  const uint32_t ring_addr = smem_addr(ring);
  const uint8_t* kq = a.kq + bh * a.T2 * D;
  const uint8_t* vq = a.vq + bh * a.T2 * D;
  const bf16* ks4 = a.ks + bh * 4 * a.T2;
  const bf16* vs4 = a.vs + bh * 4 * a.T2;
  // Copies cover the split's range inside the span, before the frontier is known (keys
  // between the frontier and hi_split are read, and selected away below); pair rows
  // past the span are zero-filled.
  const int krows = (hi_split + 1) / 2;
  const int row0 = lo / 2 + WROWS * warp;  // the warp's first pair row; + DEC_TILE / 2 a tile
  auto issue = [&](int i) {
    const uint32_t st = ring_addr + (i % DEC_STAGES) * WSTAGE;
    const int r0 = row0 + (DEC_TILE / 2) * i;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = lane + 32 * u, r = idx >> 3, c = idx & 7;
      const bool in = r0 + r < krows;
      const size_t off = in ? (size_t)(r0 + r) * D + 16 * c : 0;
      const uint32_t dst = st + r * 128 + ((c ^ (r & 7)) << 4);
      cp_async16(dst, kq + off, in ? 16 : 0);
      cp_async16(dst + WROWS * D, vq + off, in ? 16 : 0);
    }
    if (lane < 16) {  // 16 pieces: (K, V) x 4 scale rows x 2 halves of 8 pair rows
      const int which = lane >> 3, q = (lane >> 1) & 3, half = lane & 1;
      const bool in = r0 + 8 * half < krows;
      const bf16* s4 = which ? vs4 : ks4;
      cp_async16(st + 2 * WROWS * D + which * WSCALE_BYTES + q * 2 * WROWS + 16 * half,
                 in ? s4 + (size_t)q * a.T2 + r0 + 8 * half : s4, in ? 16 : 0);
    }
  };

  // the first slices' copies go out before q and the frontier are read: the latencies overlap
  {
    const int nt_copy = (hi_split - lo - 32 * warp + DEC_TILE - 1) / DEC_TILE;
#pragma unroll
    for (int i = 0; i < DEC_STAGES - 1; ++i) {
      if (i < nt_copy) issue(i);
      cp_async_commit();
    }
  }
  const int cs = a.cs[b * a.cs_stride];  // the query's position
  const int kend = min(a.nkeys, cs + 1);  // every key below it is visible to the one query
  // splits past the frontier hold no key: they write nothing and take no ticket
  const int nvalid = kend > 0 ? min(a.nsplit, (kend + a.split_keys - 1) / a.split_keys) : 0;
  if (split >= nvalid) {
    cp_async_wait<0>();  // no copy outlives the block
    if (nvalid == 0 && split == 0)  // no visible key at all: the rows are 0
      for (int i = tid; i < G * D; i += DEC_THREADS) out[i] = __float2bfloat16(0.f);
    return;
  }
  const int hi = min(kend, hi_split);
  const int nt = (hi - lo - 32 * warp + DEC_TILE - 1) / DEC_TILE;  // tiles with a visible key of this warp

  // q row gid scaled in bf16: the A fragments and its row sum (rows at or past G are 0)
  uint32_t qa[8][2];
  float qsum = 0.f;
  {
    const float sc = bf16_scale(a.scale);
    const uint4* src = reinterpret_cast<const uint4*>(a.q + ((size_t)b * a.Hq + hk * G + min(gid, G - 1)) * D) + 4 * t;
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // channels 32t + 8u .. + 7: k-steps 2u and 2u + 1
      const uint4 raw = gid < G ? __ldg(src + u) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float x0 = __bfloat162float(__float2bfloat16(bf16_lo(w[h]) * sc));
        const float x1 = __bfloat162float(__float2bfloat16(bf16_hi(w[h]) * sc));
        qa[2 * u + (h >> 1)][h & 1] = pack_bf16(x0, x1);
        qsum += x0 + x1;
      }
    }
    qsum += __shfl_xor_sync(0xffffffffu, qsum, 1);
    qsum += __shfl_xor_sync(0xffffffffu, qsum, 2);
  }
#ifdef DUO_Q4_DECODE_FMA
  __shared__ float sqf[DEC_MAX_G][D];  // q in float32 for every warp, staged by warp 0
  if (warp == 0) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      sqf[gid][32 * t + 4 * ks + 0] = bf16_lo(qa[ks][0]);
      sqf[gid][32 * t + 4 * ks + 1] = bf16_hi(qa[ks][0]);
      sqf[gid][32 * t + 4 * ks + 2] = bf16_lo(qa[ks][1]);
      sqf[gid][32 * t + 4 * ks + 3] = bf16_hi(qa[ks][1]);
    }
  }
  __syncthreads();
#endif

  float m = NEG_INF, l = 0.f, z = 0.f;  // l and z: this thread's own keys' share (summed over the quad at the end)
  float o[16][2];  // row gid, channels 32t + j and 32t + 16 + j
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = 0.f;

#pragma unroll 1
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<DEC_STAGES - 2>();  // this lane's copies of slice i have landed
    __syncwarp();  // ... and every lane's; all are done with slice i - 1, whose stage is refilled now
    if (i + DEC_STAGES - 1 < nt) issue(i + DEC_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (i % DEC_STAGES) * WSTAGE;
    const unsigned char* sk = st + 2 * WROWS * D;  // K scales; V's follow
    const int key0 = lo + DEC_TILE * i + 32 * warp;  // the even key of the slice's pair row 0

    // scores of pair rows 8grp + 2t + c, token tok (0 even, 1 odd), in float32
    float s[2][2][2], vsc[2][2][2], vzp[2][2][2];
    bool vis[2][2][2];
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#ifndef DUO_Q4_DECODE_FMA
      const int r = 8 * grp + gid;  // the pair row whose words this thread feeds to B
      const uint4 k0 = *reinterpret_cast<const uint4*>(st + r * 128 + (((2 * t) ^ (r & 7)) << 4));
      const uint4 k1 = *reinterpret_cast<const uint4*>(st + r * 128 + (((2 * t + 1) ^ (r & 7)) << 4));
      const uint32_t kw[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t e01, e23, o01, o23;
        unpack_word(kw[ks], e01, e23, o01, o23);
        mma_16816(acc[0][0], acc[0][1], qa[ks][0], qa[ks][1], e01, e23);
        mma_16816(acc[1][0], acc[1][1], qa[ks][0], qa[ks][1], o01, o23);
      }
#else
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * grp + 2 * t + c;
#pragma unroll 2
        for (int p = 0; p < 8; ++p) {
          const uint4 raw = *reinterpret_cast<const uint4*>(st + r * 128 + ((p ^ (r & 7)) << 4));
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float qv = sqf[gid][16 * p + e];
            const uint32_t byte = (w[e >> 2] >> (8 * (e & 3))) & 0xFFu;
            acc[0][c] = fmaf(qv, nib_f32(byte & 0xFu), acc[0][c]);
            acc[1][c] = fmaf(qv, nib_f32(byte >> 4), acc[1][c]);
          }
        }
      }
#endif
#pragma unroll
      for (int tok = 0; tok < 2; ++tok) {
        const int pr = 8 * grp + 2 * t;  // pair rows pr, pr + 1: one word of each scale row
        const uint32_t kscw = *reinterpret_cast<const uint32_t*>(sk + tok * 2 * WROWS + 2 * pr);
        const uint32_t kzpw = *reinterpret_cast<const uint32_t*>(sk + (2 + tok) * 2 * WROWS + 2 * pr);
        const uint32_t vscw = *reinterpret_cast<const uint32_t*>(sk + WSCALE_BYTES + tok * 2 * WROWS + 2 * pr);
        const uint32_t vzpw = *reinterpret_cast<const uint32_t*>(sk + WSCALE_BYTES + (2 + tok) * 2 * WROWS + 2 * pr);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool v = key0 + 2 * (pr + c) + tok < hi;
          const float ksc = c ? bf16_hi(kscw) : bf16_lo(kscw), kzp = c ? bf16_hi(kzpw) : bf16_lo(kzpw);
          // a key past hi may hold NaN scales (the cache there is uninitialised): selected away
          vis[grp][tok][c] = v;
          s[grp][tok][c] = v ? acc[tok][c] * ksc + qsum * kzp : NEG_INF;
          vsc[grp][tok][c] = v ? (c ? bf16_hi(vscw) : bf16_lo(vscw)) : 0.f;
          vzp[grp][tok][c] = v ? (c ? bf16_hi(vzpw) : bf16_lo(vzpw)) : 0.f;
        }
      }
    }

    // the warp's online softmax of row gid over this slice (the quad shares the row)
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < 8; ++u) mx = fmaxf(mx, (&s[0][0][0])[u]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m, mx);
    const float alpha = fast_exp2((m - m_next) * LOG2E);
    m = m_next;
    l *= alpha;
    z *= alpha;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
    float pv[2][2][2];  // p * vscale rounded to bf16
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float p = (&vis[0][0][0])[u] ? fast_exp2(((&s[0][0][0])[u] - m) * LOG2E) : 0.f;
      l += p;
      z += p * (&vzp[0][0][0])[u];
      (&pv[0][0][0])[u] = __bfloat162float(__float2bfloat16(p * (&vsc[0][0][0])[u]));
    }

#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
#ifndef DUO_Q4_DECODE_FMA
      const uint32_t pa0 = pack_bf16(pv[grp][0][0], pv[grp][1][0]);  // pair row 2t: even, odd key
      const uint32_t pa2 = pack_bf16(pv[grp][0][1], pv[grp][1][1]);  // pair row 2t + 1
      const int ra = 8 * grp + 2 * t, rb = ra + 1;
      const unsigned char* sv = st + WROWS * D;
      const uint4 va = *reinterpret_cast<const uint4*>(sv + ra * 128 + ((gid ^ (ra & 7)) << 4));
      const uint4 vb = *reinterpret_cast<const uint4*>(sv + rb * 128 + ((gid ^ (rb & 7)) << 4));
      const uint32_t wa[4] = {va.x, va.y, va.z, va.w}, wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const uint32_t a4 = wa[wi] >> 4, b4 = wb[wi] >> 4;
        mma_16816(o[4 * wi + 0][0], o[4 * wi + 0][1], pa0, pa2, byte_to_bf16x2<0>(wa[wi], a4), byte_to_bf16x2<0>(wb[wi], b4));
        mma_16816(o[4 * wi + 1][0], o[4 * wi + 1][1], pa0, pa2, byte_to_bf16x2<1>(wa[wi], a4), byte_to_bf16x2<1>(wb[wi], b4));
        mma_16816(o[4 * wi + 2][0], o[4 * wi + 2][1], pa0, pa2, byte_to_bf16x2<2>(wa[wi], a4), byte_to_bf16x2<2>(wb[wi], b4));
        mma_16816(o[4 * wi + 3][0], o[4 * wi + 3][1], pa0, pa2, byte_to_bf16x2<3>(wa[wi], a4), byte_to_bf16x2<3>(wb[wi], b4));
      }
#else
      // p of the group's 16 keys for row gid: the quad's lanes hold pair rows 2t', 2t' + 1
#pragma unroll
      for (int tq = 0; tq < 4; ++tq) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int src = (lane & ~3) | tq, r = 8 * grp + 2 * tq + c;
          const float pe = __shfl_sync(0xffffffffu, pv[grp][0][c], src);
          const float po = __shfl_sync(0xffffffffu, pv[grp][1][c], src);
          const unsigned char* sv = st + WROWS * D + r * 128;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // channels 32t + 16h .. + 15
            const uint4 raw = *reinterpret_cast<const uint4*>(sv + (((2 * t + h) ^ (r & 7)) << 4));
            const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const uint32_t byte = (w[e >> 2] >> (8 * (e & 3))) & 0xFFu;
              o[e][h] = fmaf(pe, nib_f32(byte & 0xFu), fmaf(po, nib_f32(byte >> 4), o[e][h]));
            }
          }
        }
      }
#endif
    }
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  z += __shfl_xor_sync(0xffffffffu, z, 1);
  z += __shfl_xor_sync(0xffffffffu, z, 2);

  // The block's state from its warps' (once, at the end): the ring's memory is free
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(dsmem);
  float* wstat = wacc + WACC_FLOATS;  // [m, l, z][warp][row]
  if (gid < G) {
    float* row = wacc + (warp * DEC_MAX_G + gid) * ACC_ROW + ACC_SEG * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      row[j] = o[j][0];
      row[16 + j] = o[j][1];
    }
    if (t == 0) {
      wstat[(0 * DEC_WARPS + warp) * DEC_MAX_G + gid] = m;
      wstat[(1 * DEC_WARPS + warp) * DEC_MAX_G + gid] = l;
      wstat[(2 * DEC_WARPS + warp) * DEC_MAX_G + gid] = z;
    }
  }
  __syncthreads();
  // the (b, KV head)'s partials, one a split
  float* pbase = a.part + bh * a.nsplit * G * PART;
  float* part = pbase + split * G * PART;
  for (int i = tid; i < G * D; i += DEC_THREADS) {  // column d of row g
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, wstat[w * DEC_MAX_G + g]);
    float acc = 0.f, L = 0.f, Z = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {  // a warp with no key has m = NEG_INF: weight 0
      const float f = fast_exp2((wstat[w * DEC_MAX_G + g] - M) * LOG2E);
      acc += f * wacc[(w * DEC_MAX_G + g) * ACC_ROW + (d >> 5) * ACC_SEG + (d & 31)];
      L += f * wstat[(DEC_WARPS + w) * DEC_MAX_G + g];
      Z += f * wstat[(2 * DEC_WARPS + w) * DEC_MAX_G + g];
    }
    part[g * PART + d] = acc;
    if (d == 0) {
      part[g * PART + D] = M;
      part[g * PART + D + 1] = L;
      part[g * PART + D + 2] = Z;
    }
  }

  // The last block of the (b, KV head)'s splits that hold keys merges them.
  __shared__ int ticket;
  int* cnt = a.counters + bh;
  __syncthreads();  // the block's partial is written; the ticket releases it and acquires the others
  if (tid == 0) ticket = ticket_acq_rel(cnt);
  __syncthreads();
  if (ticket != nvalid - 1) return;
  if (tid == 0) *cnt = 0;  // ready for the next launch (a replayed graph needs no memset)
  merge_partials(pbase, nvalid, G, reinterpret_cast<float*>(dsmem), out);
}

int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.S == 1) {
    static int configured = -1;  // the device the attribute was set on (a host call a launch saved)
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev != configured)
      err = cudaFuncSetAttribute(decode_q4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = dev;
    decode_q4_kernel<<<dim3(a.nsplit, a.Hkv, B), DEC_THREADS, DEC_SMEM, stream>>>(a);
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

// Decode scratch a (b, KV head) needs: floats of partials for nsplit splits
// and a query group of G.
int q4_decode_scratch_floats(int nsplit, int G) { return nsplit * G * PART; }

// q [B, S, Hq, D] bf16; k/v_packed [B, Hkv, T2, D] u8 and k/v_scales
// [B, Hkv, 4, T2] bf16 (already holding the chunk at [cs, cs+S)); cs [B] (or
// one value, cs_stride 0); out [B, S, Hq, D]. Keys at or past `span` are never
// read. Decode (S == 1): `part` is scratch of B*Hkv*q4_decode_scratch_floats()
// floats and `counters` B*Hkv ints that are 0 at the launch (the launch
// leaves them 0); split s covers keys [s*split_keys, (s+1)*split_keys),
// split_keys a multiple of 128 with nsplit*split_keys >= span and nsplit <= 32; T2 is a
// multiple of 8 (the scale rows are copied 16 bytes at a time).
int full_cache_attention_q4(const void* q, const void* k_packed, const void* k_scales,
                            const void* v_packed, const void* v_scales, const void* cs,
                            int cs_stride, void* out, int B, int S, int Hq, int Hkv, int T2,
                            int span, int head_dim, float scale, void* part, void* counters,
                            int nsplit, int split_keys, void* stream) {
  if (head_dim != D || Hq % Hkv != 0 || span > 2 * T2) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1 && (part == nullptr || counters == nullptr || nsplit < 1 || nsplit > DEC_MAX_SPLITS ||
                 split_keys % 128 != 0 || (long long)nsplit * split_keys < span ||
                 Hq / Hkv > DEC_MAX_G || T2 % 8 != 0))
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
  a.counters = static_cast<int*>(counters);
  a.nsplit = nsplit;
  a.split_keys = split_keys;
  return launch(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
