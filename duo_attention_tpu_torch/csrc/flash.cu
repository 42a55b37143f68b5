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
// Three kernels, one per shape of work:
//   * prefill (S > 1) is bound by operations at long context (4*D flops per
//     visible (query, key) pair), so the design keeps the tensor cores fed and
//     everything else out of their way. A block is two consumer warpgroups,
//     each owning 64 query rows, and one producer warpgroup that does nothing
//     but copy K/V tiles of 128 keys into a ring of three stages the
//     consumers share; stages change hands through `mbarrier`s (full: the
//     copies have landed; empty: every consumer warp is done), so the
//     warpgroups never meet at a block-wide barrier. S = Q.K^T is a `wgmma`
//     m64n128k16 with Q and K read from shared memory; the online softmax
//     runs on the accumulator's registers (a row lies in the four lanes of a
//     quad: two shuffles give its max, its sum is reduced once at the end); P
//     is rounded to bf16 in registers and is the register A operand of the
//     second `wgmma`, O += P.V (m64n128k16), which reads V in its natural
//     [keys, D] layout through the descriptor's transpose bit. O, m and l
//     stay in registers for the whole key walk and are written once: nothing
//     but Q, K and V ever sits in shared memory. Inside a warpgroup the walk
//     is software-pipelined: S of tile it+1 and P.V of tile it are started
//     together, and the softmax of tile it+1 runs under P.V of tile it. The
//     tiles arrive by `cp.async` in 16-byte pieces into the 128-byte-swizzled
//     layout `wgmma` reads. `cp.async` rather than TMA throughout: the ring
//     of the streaming heads is walked in position order, so a tile may
//     straddle the wrap, and rows past a head's frontier must be zero-filled
//     (the cache past its length is uninitialised, and 0 * NaN in P.V is
//     NaN); a per-row copy does both with no tensor map to build and keep per
//     buffer, and a producer warpgroup takes its cost off the consumers all
//     the same. Masks are applied only to tiles that cross the causal
//     diagonal, the ring's frontier or the ragged end; a tile wholly above a
//     warpgroup's rows is not multiplied. 2^x on f32 (s - m) * log2(e)
//     replaces expf(s - m): q is still scaled by the bf16-rounded scale, and
//     the two differ by a few ulp of f32, far below p's rounding to bf16.
//     What still holds it back: the products and the softmax still run
//     mostly one after the other; eight consumer warps are too few to hide
//     the softmax's dependent chains (maxima, shuffles, 2^x on the
//     special-function unit) behind the other warpgroup's products.
//   * full-head decode (S == 1) is bound by bytes (every visible K/V row is
//     read once) and, with one query row per head, by how many SMs read at
//     once. The key range of a (KV head, b) is split over blockIdx.z (the
//     wrapper's plan, made from the bucket alone); each block of 128 threads
//     runs the online softmax over its keys with the G query heads of the
//     group as rows, so K/V are read once per group, and writes (acc, m, l)
//     in f32; a merge kernel combines the splits. With one split the block
//     writes the output itself (short spans). K tiles of 128 keys are staged
//     in shared memory by `cp.async` (16 lanes read one 256-byte row:
//     coalesced), rows padded by 16 bytes so that each thread scores its own
//     key without bank conflicts; the next tile's copy runs under the softmax
//     and the P.V of this one. V rows are read straight from device memory,
//     a whole row per warp load.
//   * streaming decode (S == 1) sees at most sink + recent + 1 keys (321 on
//     the main path, ~0.16 MB of K/V a head), so neither bytes nor operations
//     bound it: a chain of latencies does (the lengths, the copies, the
//     merges). One launch spreads the visible range over (split, head, b)
//     blocks (the wrapper's plan, made from sink and recent, host integers)
//     and a block's keys over its warps, 16 keys a warp: every warp issues
//     all its K and V copies at once, so one round of memory latency covers
//     the block; the scores and P.V are m16n8k16 `mma.sync` products with the
//     G <= 8 heads as rows; each warp keeps its own online softmax, the block
//     merges its warps in shared memory, and the splits merge in the same
//     launch (see stream_decode_kernel).
//
// Lengths come from device memory ([B] int32, or one value with stride 0),
// so launching never waits for the host. Launches go on the caller's stream
// and allocate nothing: the decode scratch is the wrapper's.

#include <cooperative_groups.h>
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
  float* part;  // full-head decode scratch [B, Hkv, nsplit, G, PART] when nsplit > 1
  int nsplit, split_keys;
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
    // before the sink is full no ring token is visible, nor a sink slot past the last query
    if (qpos_max < a.sink) k.end = min(k.end, qpos_max + 1);
  }
  return k;
}

// The token that virtual key j holds; key j is visible to qpos iff token <= qpos.
template <int MODE>
__device__ __forceinline__ int token_of(const Args& a, int j, int glo) {
  return (MODE == MODE_FULL || j < a.sink) ? j : glo + (j - a.sink);
}

// Where the K/V rows of one (b, KV head) lie: key j of the walk is row j of
// the first buffer (the cache, or the sink buffer) or, for a streaming head's
// j >= sink, the ring slot of token glo + (j - sink).
struct Rows {
  const bf16 *k0, *v0, *k1, *v1;
  int sink, R;
  int glo_mod;  // glo mod R, taken once: a walk covers fewer than R ring tokens
};

template <int MODE>
__device__ __forceinline__ Rows rows_of(const Args& a, int b, int hk, int glo) {
  const size_t bh = (size_t)b * a.Hkv + hk;
  Rows r = {};
  r.k0 = a.k0 + bh * a.T0 * D;
  r.v0 = a.v0 + bh * a.T0 * D;
  if (MODE == MODE_STREAM) {
    r.k1 = a.k1 + bh * a.R * D;
    r.v1 = a.v1 + bh * a.R * D;
    r.sink = a.sink;
    r.R = a.R;
    r.glo_mod = pmod(glo, a.R);
  }
  return r;
}

template <int MODE>
__device__ __forceinline__ void kv_row(const Rows& r, int j, const bf16*& kp, const bf16*& vp) {
  if (MODE == MODE_STREAM && j >= r.sink) {
    int slot = r.glo_mod + (j - r.sink);  // below 2R
    if (slot >= r.R) slot -= r.R;
    kp = r.k1 + slot * D;
    vp = r.v1 + slot * D;
  } else {
    kp = r.k0 + j * D;
    vp = r.v0 + j * D;
  }
}

__device__ __forceinline__ float bf16_scale(float scale) {
  return __bfloat162float(__float2bfloat16(scale));
}

// ---------------------------------------------------------------------------
// Prefill: a producer and two consumer warpgroups, wgmma, accumulators in registers
// ---------------------------------------------------------------------------

constexpr int NWG = 2;  // consumer warpgroups a block, 64 query rows each
constexpr int BQ = 64 * NWG, BK = 128;
constexpr int PF_THREADS = 128 * (NWG + 1);  // and one producer warpgroup that copies K/V
constexpr int NSTAGE = 3;  // K/V stages: two tiles are multiplied while a third is copied
// A panel is rows of 64 bf16 (128 bytes a row) in the 128-byte swizzle: the
// 16-byte piece c of row r sits at piece c ^ (r & 7). A warpgroup's Q and a
// K or V tile are two panels each (D = 128 = two panels side by side), of 64
// and of BK rows.
constexpr int PANEL = 64 * 128;
constexpr int Q_BYTES = (BQ / 64) * 2 * PANEL;
constexpr int KPANEL = BK * 128;  // a K or V panel: BK rows of 128 bytes
constexpr int STAGE_BYTES = 4 * KPANEL;  // K panels 0, 1, then V panels 0, 1
// + 2 * NSTAGE barriers of 8 bytes, + room to align to 1024
constexpr int PREFILL_SMEM = Q_BYTES + NSTAGE * STAGE_BYTES + 16 * NSTAGE + 1024;

template <int MODE>
__global__ void __launch_bounds__(PF_THREADS, 1) prefill_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // panels need 1024-byte alignment (the swizzle pattern repeats every 1024 bytes)
  unsigned char* base = smem + ((1024u - (smem_addr(smem) & 1023u)) & 1023u);
  unsigned char* sQ = base;
  const uint32_t sQ_addr = smem_addr(base);
  const uint32_t stage0_addr = sQ_addr + Q_BYTES;
  // full[s]: the copies of the tile in stage s have landed (one arrival per
  // producer thread, made by its last copy); empty[s]: every consumer warp is
  // done reading stage s (one arrival per warp)
  const uint32_t full_addr = stage0_addr + NSTAGE * STAGE_BYTES, empty_addr = full_addr + 8 * NSTAGE;

  // the heaviest query tiles (the latest positions) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];
  const int t = MODE == MODE_STREAM ? a.total[b * a.total_stride] : 0;
  const int rows = min(BQ, a.S - q0);
  const Keys keys = key_range<MODE>(a, cs, t, cs + q0 + rows - 1);
  const int kend = keys.end;
  const int ntiles = (kend + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(full_addr + 8 * st, 128);
      mbar_init(empty_addr + 8 * st, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // From here the roles never meet again: one producer warpgroup that copies,
  // NWG consumer warpgroups that multiply. Stages go round by the barriers
  // above. The producer hands most of its registers to the consumers
  // (2 * 128 * 240 + 128 * 24 of the SM's 65,536).
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    // One K/V tile into a stage, in pieces of 16 bytes: 16 neighbouring threads
    // copy one 256-byte row of K and of V. Rows at or past kend are zeros.
    const Rows src_rows = rows_of<MODE>(a, b, hk, keys.glo);
    const int ptid = tid & 127, c = ptid & 15;
    const uint32_t piece = (c >> 3) * KPANEL;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int stage = tile % NSTAGE;
      // the tile that held this stage before has been multiplied by everyone
      if (tile >= NSTAGE) mbar_wait(empty_addr + 8 * stage, (tile / NSTAGE - 1) & 1);
      const uint32_t st = stage0_addr + stage * STAGE_BYTES;
#pragma unroll 4
      for (int r = ptid >> 4; r < BK; r += 8) {
        const int j = tile * BK + r;
        const bf16 *kp = a.k0, *vp = a.v0;
        int nbytes = 0;
        if (j < kend) {
          kv_row<MODE>(src_rows, j, kp, vp);
          kp += c * 8;
          vp += c * 8;
          nbytes = 16;
        }
        const uint32_t dst = st + piece + swz(r, c & 7);
        cp_async16(dst, kp, nbytes);
        cp_async16(dst + 2 * KPANEL, vp, nbytes);
      }
      cp_async_mbar_arrive(full_addr + 8 * stage);
    }
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
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
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma may read what was stored
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");   // the warpgroup's own barrier

  // This thread's two rows of its warpgroup's 64: r0 and r0 + 8. In a
  // 64 x N accumulator, element 4j + e lies in row r0 + 8 * (e >> 1) and
  // column 8j + 2 * (lane & 3) + (e & 1).
  const int r0 = warp * 16 + (lane >> 2);
  const int qrow0 = q0 + wg * 64 + r0;  // row in the chunk
  const int qpos0 = cs + qrow0;
  const int wg_qmin = cs + q0 + wg * 64, wg_qmax = wg_qmin + 63;
  const int cq = 2 * (lane & 3);
  // The tiles this warpgroup multiplies: those that hold a key one of its rows
  // sees (tokens rise along the walk, so they are the first n_wg). It still
  // waits for the rest and releases them, one by one, as the barriers count.
  const int jmax = (MODE == MODE_FULL || wg_qmax < a.sink)
                       ? wg_qmax
                       : (wg_qmax >= keys.glo ? a.sink + (wg_qmax - keys.glo) : a.sink - 1);
  const int n_wg = min(ntiles, (jmax + BK) / BK);

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum
  float s[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = 0u;

  const uint64_t dq0 = make_desc(sQ_addr + wg * 2 * PANEL, 16, 1024);
  // S = (q * scale) K^T of one tile: 8 steps of 16 over D; a step is 32 bytes
  // inside a panel's 128-byte rows, and the second panel follows the first
  auto start_qk = [&](int tile) {
    const uint64_t dk0 = make_desc(stage0_addr + (tile % NSTAGE) * STAGE_BYTES, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t oq = (uint64_t)(((kk >> 2) * PANEL + (kk & 3) * 32) >> 4);
      const uint64_t ok = (uint64_t)(((kk >> 2) * KPANEL + (kk & 3) * 32) >> 4);
      wgmma_m64n128k16_ss(s, dq0 + oq, dk0 + ok, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of one tile: 8 steps of 16 keys; a step is 16 rows of 128 bytes in each V panel
  auto start_pv = [&](int tile) {
    const uint64_t dv0 =
        make_desc(stage0_addr + (tile % NSTAGE) * STAGE_BYTES + 2 * KPANEL, KPANEL, 1024);
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
  // The online softmax of the tile in s, in place: masks, the new row maxima,
  // the scales of what came before (al0, al1), e^(s - m) in f32, the row sums.
  auto softmax = [&](int tile) {
    const int k0 = tile * BK;
    // masks only where they bite: the diagonal, the ring's frontier, the ragged end
    const bool masked = k0 + BK > kend || token_of<MODE>(a, k0 + BK - 1, keys.glo) > wg_qmin;
    if (masked) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int j = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qpos = qpos0 + 8 * ((i >> 1) & 1);
        if (!(j < kend && token_of<MODE>(a, j, keys.glo) <= qpos)) s[i] = NEG_INF;
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      float p0 = fast_exp2(fmaf(s[i], LOG2E, -ml0)), p1 = fast_exp2(fmaf(s[i + 1], LOG2E, -ml0));
      float p2 = fast_exp2(fmaf(s[i + 2], LOG2E, -ml1)), p3 = fast_exp2(fmaf(s[i + 3], LOG2E, -ml1));
      if (masked) {  // a masked score is exactly NEG_INF; its row's max may be NEG_INF too
        p0 = s[i] == NEG_INF ? 0.f : p0;
        p1 = s[i + 1] == NEG_INF ? 0.f : p1;
        p2 = s[i + 2] == NEG_INF ? 0.f : p2;
        p3 = s[i + 3] == NEG_INF ? 0.f : p3;
      }
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      s[i] = p0;
      s[i + 1] = p1;
      s[i + 2] = p2;
      s[i + 3] = p3;
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
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

  // Tile `tile` has landed in its stage, and wgmma may read it.
  auto wait_tile = [&](int tile) {
    mbar_wait(full_addr + 8 * (tile % NSTAGE), (tile / NSTAGE) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // The walk, software-pipelined inside the warpgroup: S of tile it+1 and P.V
  // of tile it are started together, and the softmax of tile it+1 runs under
  // P.V of tile it. The warpgroups run free of each other: one's softmax can
  // fall under the other's products.
  if (0 < ntiles) wait_tile(0);
  if (0 < n_wg) {
    start_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    rescale_and_pack();
    // (the steady state has no branch around a product or its wait: the
    // assembler gives up overlapping them otherwise)
    for (int it = 0; it < n_wg - 1; ++it) {
      wait_tile(it + 1);
      start_qk(it + 1);
      start_pv(it);
      wgmma_wait<1>();  // S(it+1) is complete; P.V(it) runs on
      fence_regs(s);
      softmax(it + 1);
      fence_regs(s);  // the exponentials are taken before the wait below, under P.V(it), not after it
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty_addr + 8 * (it % NSTAGE));  // this warp is done with tile it
      rescale_and_pack();
    }
    const int last = n_wg - 1;
    if (last + 1 < ntiles) wait_tile(last + 1);
    start_pv(last);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty_addr + 8 * (last % NSTAGE));
  }
  // tiles wholly above this warpgroup's rows: waited for and released, as the barriers count
  for (int it = n_wg; it < ntiles; ++it) {
    if (it + 1 < ntiles) wait_tile(it + 1);
    if (lane == 0) mbar_arrive(empty_addr + 8 * (it % NSTAGE));
  }
  fence_regs(o);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qrow0 + 8 * half;
    if (row < a.S) {
      bf16* dst = a.out + (((size_t)b * a.S + row) * a.Hq + h) * D + cq;
      const float inv = half ? inv1 : inv0;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<uint32_t*>(dst + 8 * jn) =
            pack_bf16(o[4 * jn + 2 * half] * inv, o[4 * jn + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Full-head decode: blocks over (KV head, b, key split), the G grouped query
// heads as rows; then a merge when there is more than one split
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = D;  // thread d owns output column d; a K tile is one key a thread
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int LDKD = D + 8;  // K rows padded by 16 bytes: 8 threads' uint4 reads hit 8 bank groups
constexpr int DEC_SMEM = DEC_THREADS * LDKD * (int)sizeof(bf16);
constexpr int PART = D + 2;  // per (split, query head): D sums, then the max and the denominator

template <int G>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [DEC_THREADS][LDKD]
  float* sacc = reinterpret_cast<float*>(smem);  // [DEC_WARPS][G][D], after the key walk
  static_assert(DEC_WARPS * G * D * sizeof(float) <= DEC_SMEM, "sacc must fit in the K tile");
  __shared__ float sq[G][D];
  __shared__ float sp[G][DEC_THREADS];
  __shared__ float red[G][DEC_WARPS];
  __shared__ float sm[G], sl[G], salpha[G];

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.cs[b * a.cs_stride];  // the query's position
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
  const Keys keys = key_range<MODE_FULL>(a, cs, 0, cs);
  // this block's keys: [lo, hi) of the visible range; every key below keys.end
  // is visible to the one query
  const int lo = split * a.split_keys;
  const int hi = min(keys.end, lo + a.split_keys);

  const Rows src_rows = rows_of<MODE_FULL>(a, b, hk, keys.glo);
  // A K tile into shared memory: 16 neighbouring threads copy one 256-byte row.
  auto load_k = [&](int k0) {
    const uint32_t dst = smem_addr(sK);
#pragma unroll 4
    for (int i = tid; i < DEC_THREADS * (D / 8); i += DEC_THREADS) {
      const int r = i >> 4, c = i & 15;
      if (k0 + r < hi) {
        const bf16 *kp, *vp;
        kv_row<MODE_FULL>(src_rows, k0 + r, kp, vp);
        cp_async16(dst + (r * LDKD + c * 8) * (int)sizeof(bf16), kp + c * 8, 16);
      }
    }
    cp_async_commit();
  };
  load_k(lo);

  for (int k0 = lo; k0 < hi; k0 += DEC_THREADS) {
    cp_async_wait<0>();
    __syncthreads();  // the K tile (and, the first time, sq, sm, sl) is ready
    const int j = k0 + tid;
    const bool vis = j < hi;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = NEG_INF;
    if (vis) {
      const bf16* kp = sK + tid * LDKD;
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
    __syncthreads();  // every thread has scored its key: the K tile is free
    if (k0 + DEC_THREADS < hi) load_k(k0 + DEC_THREADS);  // lands under the softmax and P.V below
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
    const int jend = min(32 * warp + 32, hi - k0);
#pragma unroll 8
    for (int jj = 32 * warp; jj < jend; ++jj) {
      const bf16 *kp, *vp;
      kv_row<MODE_FULL>(src_rows, k0 + jj, kp, vp);
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

  cp_async_wait<0>();
  __syncthreads();  // no copy is in flight and no thread reads the K tile: sacc may take its place
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[(warp * G + g) * D + 4 * lane + c] = acc[g][c];
  __syncthreads();
  if (a.nsplit == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) o += sacc[(w * G + g) * D + tid];
      float l = sl[g];
      if (l == 0.f) l = 1.f;
      a.out[((size_t)b * a.Hq + hk * G + g) * D + tid] = __float2bfloat16(o / l);
    }
    return;
  }
  // an empty split leaves m = NEG_INF, l = 0, acc = 0: it weighs nothing in the merge
  float* part = a.part + ((((size_t)b * a.Hkv + hk) * a.nsplit + split) * G) * PART;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) o += sacc[(w * G + g) * D + tid];
    part[g * PART + tid] = o;
  }
  if (tid < G) {
    part[tid * PART + D] = sm[tid];
    part[tid * PART + D + 1] = sl[tid];
  }
}

// out[b, h, :] from the splits' states: out = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s with M = max_s m_s. With every split empty M is
// NEG_INF, the weights are 1, the sums 0, and the row is 0.
__global__ void __launch_bounds__(DEC_THREADS) decode_merge_kernel(Args a) {
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
    o += w * p[d];
    l += w * p[D + 1];
  }
  if (l == 0.f) l = 1.f;
  a.out[((size_t)b * a.Hq + h) * D + d] = __float2bfloat16(o / l);
}

// ---------------------------------------------------------------------------
// Streaming decode: one launch, a thread-block cluster per (streaming KV head,
// b) over the splits of its keys; a warp takes 16 keys at a time on mma.sync,
// a block merges its warps, and the cluster's leader merges the blocks
// ---------------------------------------------------------------------------

constexpr int ST_TILE = 16;  // keys a warp takes at a time: one k-step of the m16n8k16 P.V
constexpr int ST_MAX_WARPS = 8;
constexpr int ST_MAX_SPLITS = 8;  // blocks a cluster: the portable cluster size
constexpr int ST_MAX_G = 8;  // the rows of an m16n8k16 tile that hold a head (8-15 are zero)
// A warp's K rows are 320 bytes apart: the 16-byte fragment loads of a
// quarter-warp (rows gid and gid + 1, 16t + 64u bytes in) fall in 8 distinct
// 16-byte bank groups. V rows are 272 bytes apart: the 8 row addresses of an
// ldmatrix phase do the same.
constexpr int ST_LDK = D + 32, ST_LDV = D + 8;
constexpr int ST_WARP_SMEM = ST_TILE * (ST_LDK + ST_LDV) * (int)sizeof(bf16);
// After its walk a warp's output rows (float) take its K area, 136 floats
// apart: a half-warp's float2 stores, (row gid, column 8j + 2t), hit 32 banks.
constexpr int ST_ACC_LD = D + 8;
static_assert(ST_MAX_G * ST_ACC_LD * 4 <= ST_TILE * ST_LDK * 2, "a warp's rows must fit in its K area");
// A block's state in the leader's shared memory: acc [G][D], then m [8] and l [8]
__host__ __device__ constexpr int st_slot_floats(int G) { return G * D + 2 * ST_MAX_G; }
__host__ __device__ constexpr int st_smem_bytes(int warps, int nsplit, int G) {
  return warps * ST_WARP_SMEM + nsplit * st_slot_floats(G) * (int)sizeof(float);
}

// B fragments of two n-tiles (8 keys x 16 channels each way) from V rows in
// their natural [key][channel] layout, transposed by the load.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// Merges n <= N states (m_s, l_s, acc_s) of one row into four of its columns:
// M = max m_s, w_s = e^(m_s - M), acc = sum w_s acc_s, l = sum w_s l_s. A state
// with no key (m = NEG_INF) weighs 0 beside one that has keys; the loops are
// unrolled so that every load goes out before the first is needed.
template <int N, typename Stat, typename Acc>
__device__ __forceinline__ void merge4(int n, Stat stat, Acc acc4, float4& acc, float& l, float& M) {
  float ms[N];
  M = NEG_INF;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    ms[s] = s < n ? stat(s, 0) : NEG_INF;
    M = fmaxf(M, ms[s]);
  }
  acc = make_float4(0.f, 0.f, 0.f, 0.f);
  l = 0.f;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    if (s < n) {
      const float w = fast_exp2((ms[s] - M) * LOG2E);
      const float4 x = acc4(s);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
      l += w * stat(s, 1);
    }
  }
}

__device__ __forceinline__ uint32_t cluster_map(uint32_t smem_addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr), "r"(rank));
  return out;
}

// The channels of a k-step are renumbered (the sum over them is the same):
// k-step 2u + h of thread t holds channels 32u + 8t + 4h + {0, 1} (k 2t, 2t + 1)
// and + {2, 3} (k 2t + 8, 2t + 9), so a thread's A fragments of every k-step
// are one 64-byte run of q row gid, and its B fragments of k-steps 2u, 2u + 1
// one 16-byte load of a K row. P.V keeps the keys in order: the S fragments
// of n-tiles 0 and 1 are P's A fragment as they stand.
//
// The merges: each block merges its warps' states in one unrolled pass (a
// thread takes four columns of a row) and stores the result straight into
// its slot in the shared memory of the cluster's leader (block 0), then
// arrives on the leader's mbarrier (release at cluster scope) and exits; the
// leader waits for every block (acquire), merges the slots of the splits that
// hold keys, and writes the G rows. One cluster-wide barrier, early and off
// the critical path, makes the leader's mbarrier known to the others before
// they arrive on it; the leader outlives every access to its memory.
__global__ void __launch_bounds__(32 * ST_MAX_WARPS) stream_decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float wm[ST_MAX_WARPS][ST_MAX_G], wl[ST_MAX_WARPS][ST_MAX_G];
  __shared__ __align__(8) uint64_t landed;  // the leader's: one arrival a block of the cluster
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;  // split is the block's rank in the cluster
  const int nwarps = blockDim.x >> 5, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int G = a.G;
  float* slots = reinterpret_cast<float*>(smem + nwarps * ST_WARP_SMEM);  // the leader's: one a block
  const uint32_t landed_addr = smem_addr(&landed);
  if (split == 0 && tid == 0) {
    mbar_init(landed_addr, a.nsplit);
    mbar_init_fence();
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");  // waited on before the first remote access

  const int cs = a.cs[b * a.cs_stride];  // the query's position
  const Keys keys = key_range<MODE_STREAM>(a, cs, a.total[b * a.total_stride], cs);
  const int end = keys.end;  // every key below it is visible to the one query
  const int lo = split * a.split_keys, hi = min(end, lo + a.split_keys);  // the block's keys
  const int wkeys = ST_TILE * ((a.split_keys / ST_TILE + nwarps - 1) / nwarps);  // a warp's share
  const int wlo = lo + warp * wkeys, whi = min(hi, wlo + wkeys);  // this warp's keys
  const int ntiles = whi > wlo ? (whi - wlo + ST_TILE - 1) / ST_TILE : 0;

  // The warp's 16 K and V rows of a tile, 16 lanes to a 256-byte row; rows at or
  // past whi are zeros (0 * NaN in P.V would be NaN).
  bf16* sK = reinterpret_cast<bf16*>(smem + warp * ST_WARP_SMEM);
  bf16* sV = sK + ST_TILE * ST_LDK;
  const Rows src = rows_of<MODE_STREAM>(a, b, hk, keys.glo);
  auto issue = [&](int k0) {
#pragma unroll
    for (int u = 0; u < ST_TILE / 2; ++u) {
      const int r = 2 * u + (lane >> 4), c = lane & 15, j = k0 + r;
      const bf16 *kp = a.k0, *vp = a.v0;
      int nbytes = 0;
      if (j < whi) {
        kv_row<MODE_STREAM>(src, j, kp, vp);
        kp += c * 8;
        vp += c * 8;
        nbytes = 16;
      }
      cp_async16(smem_addr(sK + r * ST_LDK + c * 8), kp, nbytes);
      cp_async16(smem_addr(sV + r * ST_LDV + c * 8), vp, nbytes);
    }
    cp_async_commit();
  };
  if (ntiles > 0) issue(wlo);  // every warp's first copies go out at once: one round of latency

  // q row gid scaled in bf16, as A fragments (rows at or past G are 0)
  uint32_t qa[8][2];
  {
    const float sc = bf16_scale(a.scale);
    const uint4* qrow = reinterpret_cast<const uint4*>(a.q + ((size_t)b * a.Hq + hk * G + min(gid, G - 1)) * D) + tq;
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // channels 32u + 8t .. + 7: k-steps 2u and 2u + 1
      const uint4 raw = gid < G ? __ldg(qrow + 4 * u) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int h = 0; h < 4; ++h)
        qa[2 * u + (h >> 1)][h & 1] = pack_bf16(bf16_lo(w[h]) * sc, bf16_hi(w[h]) * sc);
    }
  }

  float m = NEG_INF, l = 0.f;  // row gid's; l this thread's keys' share (summed over the quad at the end)
  float o[D / 8][2];  // row gid, channels 8j + 2t and 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = 0.f;
  // V fragments: lane gives row (lane & 7) + 8 ((lane >> 3) & 1), 8 channels at 8 (lane >> 4)
  const uint32_t vrow = smem_addr(sV + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ST_LDV + 8 * (lane >> 4));
  for (int i = 0; i < ntiles; ++i) {
    const int k0 = wlo + ST_TILE * i;
    if (i > 0) {  // a warp with more than one tile (a window past the plan's one tile a warp)
      __syncwarp();
      issue(k0);
    }
    cp_async_wait<0>();
    __syncwarp();
    // S of keys k0 + 8nt + 2t + c: n-tile nt's B fragment is K row 8nt + gid
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint4 kw = *reinterpret_cast<const uint4*>(sK + (8 * nt + gid) * ST_LDK + 32 * u + 8 * tq);
        mma_16816(s[nt][0], s[nt][1], qa[2 * u][0], qa[2 * u][1], kw.x, kw.y);
        mma_16816(s[nt][0], s[nt][1], qa[2 * u + 1][0], qa[2 * u + 1][1], kw.z, kw.w);
      }
    }
    bool vis[2][2];
    float mx = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        vis[nt][c] = k0 + 8 * nt + 2 * tq + c < whi;
        mx = fmaxf(mx, vis[nt][c] ? s[nt][c] : NEG_INF);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m, mx);
    const float alpha = fast_exp2((m - m_next) * LOG2E);
    m = m_next;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[nt][c] = vis[nt][c] ? fast_exp2((s[nt][c] - m) * LOG2E) : 0.f;
        l += p[nt][c];
      }
    // P (rounded to bf16) of keys 2t, 2t + 1 and 2t + 8, 2t + 9: the A fragment of O += P V
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(vrow + 32 * jj, b0, b1, b2, b3);
      mma_16816(o[2 * jj][0], o[2 * jj][1], pa0, pa2, b0, b1);
      mma_16816(o[2 * jj + 1][0], o[2 * jj + 1][1], pa0, pa2, b2, b3);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // The warp's state into its K area and wm/wl
  __syncwarp();  // every lane is done reading the K area
  if (ntiles > 0 && gid < G) {
    float* wacc = reinterpret_cast<float*>(sK);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(wacc + gid * ST_ACC_LD + 8 * j + 2 * tq) = make_float2(o[j][0], o[j][1]);
    if (tq == 0) {
      wm[warp][gid] = m;
      wl[warp][gid] = l;
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // the leader's mbarrier is ready

  // The block's state from its warps' (a thread: four columns of a row), into
  // its slot in the leader's memory
  const int nvw = hi > lo ? min(nwarps, (hi - lo + wkeys - 1) / wkeys) : 0;  // warps that hold keys
  const int slot_floats = st_slot_floats(G);
  float* slot = static_cast<float*>(cooperative_groups::this_cluster().map_shared_rank(slots, 0)) +
                split * slot_floats;
  for (int i = tid; i < G * (D / 4) && nvw > 0; i += blockDim.x) {
    const int g = i / (D / 4), c4 = 4 * (i % (D / 4));
    float4 acc;
    float L, M;
    merge4<ST_MAX_WARPS>(
        nvw, [&](int w, int which) { return which ? wl[w][g] : wm[w][g]; },
        [&](int w) {
          return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(smem + w * ST_WARP_SMEM) +
                                                  g * ST_ACC_LD + c4);
        },
        acc, L, M);
    *reinterpret_cast<float4*>(slot + g * D + c4) = acc;
    if (c4 == 0) {
      slot[G * D + g] = M;
      slot[G * D + ST_MAX_G + g] = L;
    }
  }
  __syncthreads();  // the block's stores are made; the arrival below releases them to the leader
  if (tid == 0)
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_map(landed_addr, 0))
                 : "memory");
  if (split != 0) return;

  // The leader: every block's state has landed; merge those of the splits that hold keys
  {
    uint32_t done;
    do {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(landed_addr)
          : "memory");
    } while (!done);
  }
  const int nvalid = end > 0 ? min(a.nsplit, (end + a.split_keys - 1) / a.split_keys) : 0;
  bf16* out = a.out + ((size_t)b * a.Hq + hk * G) * D;  // the group's G rows
  for (int i = tid; i < G * (D / 4); i += blockDim.x) {
    const int g = i / (D / 4), c4 = 4 * (i % (D / 4));
    float4 acc;
    float L, M;
    merge4<ST_MAX_SPLITS>(
        nvalid, [&](int s, int which) { return slots[s * slot_floats + G * D + which * ST_MAX_G + g]; },
        [&](int s) { return *reinterpret_cast<const float4*>(slots + s * slot_floats + g * D + c4); }, acc, L, M);
    const float inv = 1.f / (L == 0.f ? 1.f : L);  // no visible key at all: the row is 0
    *reinterpret_cast<uint2*>(out + g * D + c4) =
        make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
  }
}

// An empty kernel: the launch floor that the decode kernels are measured
// against (chip_smoke.py launches it as the streaming decode is launched).
__global__ void empty_kernel() {}

// A launch with an optional cluster of `cluster` blocks along x (0: none).
template <typename... KArgs, typename... Args2>
cudaError_t launch_ex(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem, int cluster, cudaStream_t stream,
                      Args2... args) {
  if (cluster <= 0) {
    kernel<<<grid, block, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

int launch_stream_decode(const Args& a, int B, cudaStream_t stream) {
  static int configured = -1;  // the device the attribute was set on (a host call a launch saved)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != configured)
    err = cudaFuncSetAttribute(stream_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               st_smem_bytes(ST_MAX_WARPS, ST_MAX_SPLITS, ST_MAX_G));
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = dev;
  const int warps = min(ST_MAX_WARPS, a.split_keys / ST_TILE);
  return static_cast<int>(launch_ex(stream_decode_kernel, dim3(a.nsplit, a.Hkv, B), dim3(32 * warps),
                                    st_smem_bytes(warps, a.nsplit, a.G), a.nsplit, stream, a));
}

int launch_full_decode(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(a.Hkv, B, a.nsplit);
  switch (a.G) {
#define DUO_DECODE_CASE(NG) \
  case NG:                  \
    decode_kernel<NG><<<grid, DEC_THREADS, DEC_SMEM, stream>>>(a); \
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
  if (a.nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_merge_kernel<<<dim3(a.Hq, B), DEC_THREADS, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_prefill(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(prefill_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, PREFILL_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
  prefill_kernel<MODE><<<grid, PF_THREADS, PREFILL_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Floats of decode scratch per (b, KV head, split, query head of the group).
int decode_partial_floats() { return PART; }

// q [B, S, Hq, D]; k/v [B, Hkv, T, D] (already holding the chunk at
// [cs, cs+S)); cs [B] (or one value, cs_stride 0); out [B, S, Hq, D].
// Keys at or past `span` are never read. Decode (S == 1): split s covers keys
// [s*split_keys, (s+1)*split_keys), split_keys a multiple of the 128-key tile
// with nsplit*split_keys >= span; with nsplit > 1, `part` is scratch of
// B*Hkv*nsplit*G*decode_partial_floats() floats.
int full_cache_attention(const void* q, const void* k, const void* v, const void* cs,
                         int cs_stride, void* out, int B, int S, int Hq, int Hkv, int T,
                         int span, int head_dim, float scale, void* part, int nsplit,
                         int split_keys, void* stream) {
  if (head_dim != D || Hq % Hkv != 0 || span > T) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1 && (nsplit < 1 || (nsplit > 1 && part == nullptr) || split_keys % DEC_THREADS != 0 ||
                 (long long)nsplit * split_keys < span))
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.split_keys = split_keys;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S == 1 ? launch_full_decode(a, B, st) : launch_prefill<MODE_FULL>(a, B, st);
}

// q [B, S, Hq, D]; k/v_sink [B, Hs, Ts, D]; k/v_ring [B, Hs, R, D] (already
// holding the chunk); cs and total [B] (or one value, stride 0). Decode (S ==
// 1): split s covers keys [s*split_keys, (s+1)*split_keys) of the visible
// range (at most sink + recent + 1 keys), split_keys a multiple of 16 with
// nsplit*split_keys >= sink + recent + 1 and nsplit <= 8 (a cluster of nsplit
// blocks a (b, head)).
int streaming_cache_attention(const void* q, const void* k_sink, const void* v_sink,
                              const void* k_ring, const void* v_ring, const void* cs,
                              int cs_stride, const void* total, int total_stride, void* out,
                              int B, int S, int Hq, int Hs, int Ts, int R, int head_dim,
                              int sink, int recent, float scale, int nsplit, int split_keys, void* stream) {
  if (head_dim != D || Hq % Hs != 0 || sink > Ts || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1 && (Hq / Hs > ST_MAX_G || nsplit < 1 || nsplit > ST_MAX_SPLITS || split_keys % ST_TILE != 0 ||
                 (long long)nsplit * split_keys < (long long)sink + recent + 1))
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
  a.nsplit = nsplit;
  a.split_keys = split_keys;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S == 1 ? launch_stream_decode(a, B, st) : launch_prefill<MODE_STREAM>(a, B, st);
}

// One launch of an empty kernel over `blocks` blocks of `threads` threads, in
// clusters of `cluster` blocks (0: none): the launch floor.
int empty_kernel_launch(int blocks, int threads, int cluster, void* stream) {
  return static_cast<int>(
      launch_ex(empty_kernel, dim3(blocks), dim3(threads), 0, cluster, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
