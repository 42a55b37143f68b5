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
//     read once) and, with one query row per head, by how many bytes are in
//     flight at once. The pool's rows have lengths far apart, some with no
//     query at all, so no plan made on the host from the bucket fills the
//     card. Every block instead reads the B lengths itself and takes an
//     equal share of the (b, KV head, 128-key tile) space of the keys that
//     are read: min(cs + 1, bucket) a row, none for a row whose `valid` is 0.
//     The grid is fixed (two blocks an SM, from host integers), so a launch
//     reads nothing back and a captured step replays as lengths change. In a
//     block four warps take 16-key chunks of a (b, KV head) in turn, each
//     through its own ring of three chunks (K and V by `cp.async`, two in
//     flight while one is multiplied: 128 KB of loads in flight an SM), with
//     the G query heads as the rows of m16n8k16 `mma.sync` products (scores
//     and P.V, as the streaming decode); rows are swizzled so that the
//     fragment loads meet no bank conflict. A block merges its warps and
//     writes one (acc, m, l) partial a (b, KV head) its share touches, at
//     slot block + pair (unique: both rise together along the space); the
//     merge kernel finds which blocks touched a pair from the same lengths
//     and combines their partials in block order, so the result does not
//     depend on timing.
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

// Every kernel is a template on the head_dim D: 128 (every preset) or 64 (the
// constructed circuits); the C entries below refuse any other.
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
  int nsplit, split_keys;  // the streaming decode's plan
  // full-head decode: real queries a row ([B] or one value, stride 0; null: every row),
  // the rows, the grid's blocks, and the partials [nblocks + B * Hkv][decode_partial_floats]
  const int* valid;
  int valid_stride;
  int B, nblocks;
  float* part;
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

template <int MODE, int D>
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

template <int MODE, int D>
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
// K or V tile are D / 64 panels each (two side by side at D = 128, one at
// 64), of 64 and of BK rows.
constexpr int PANEL = 64 * 128;
constexpr int KPANEL = BK * 128;  // a K or V panel: BK rows of 128 bytes
template <int D>
struct Prefill {
  static constexpr int PANELS = D / 64;
  static constexpr int Q_BYTES = (BQ / 64) * PANELS * PANEL;
  static constexpr int STAGE_BYTES = 2 * PANELS * KPANEL;  // the K panels, then the V panels
  // + 2 * NSTAGE barriers of 8 bytes, + room to align to 1024
  static constexpr int SMEM = Q_BYTES + NSTAGE * STAGE_BYTES + 16 * NSTAGE + 1024;
};

template <int MODE, int D>
__global__ void __launch_bounds__(PF_THREADS, 1) prefill_kernel(Args a) {
  constexpr int PANELS = Prefill<D>::PANELS, Q_BYTES = Prefill<D>::Q_BYTES;
  constexpr int STAGE_BYTES = Prefill<D>::STAGE_BYTES;
  constexpr int PPR = D / 8;  // 16-byte pieces a row of K, V or Q
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
    // One K/V tile into a stage, in pieces of 16 bytes: D / 8 neighbouring
    // threads copy one row of K and of V. Rows at or past kend are zeros.
    const Rows src_rows = rows_of<MODE, D>(a, b, hk, keys.glo);
    const int ptid = tid & 127, c = ptid % PPR;
    const uint32_t piece = (c >> 3) * KPANEL;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int stage = tile % NSTAGE;
      // the tile that held this stage before has been multiplied by everyone
      if (tile >= NSTAGE) mbar_wait(empty_addr + 8 * stage, (tile / NSTAGE - 1) & 1);
      const uint32_t st = stage0_addr + stage * STAGE_BYTES;
#pragma unroll 4
      for (int r = ptid / PPR; r < BK; r += 128 / PPR) {
        const int j = tile * BK + r;
        const bf16 *kp = a.k0, *vp = a.v0;
        int nbytes = 0;
        if (j < kend) {
          kv_row<MODE, D>(src_rows, j, kp, vp);
          kp += c * 8;
          vp += c * 8;
          nbytes = 16;
        }
        const uint32_t dst = st + piece + swz(r, c & 7);
        cp_async16(dst, kp, nbytes);
        cp_async16(dst + PANELS * KPANEL, vp, nbytes);
      }
      cp_async_mbar_arrive(full_addr + 8 * stage);
    }
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const float sc = bf16_scale(a.scale);
  // Q of this warpgroup's 64 rows, scaled in bf16, into its swizzled panels; rows past S are zero
  for (int i = tid & 127; i < 64 * PPR; i += 128) {
    const int r = i / PPR, c = i % PPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (wg * 64 + r < rows) {
      val = *reinterpret_cast<const uint4*>(a.q + (((size_t)b * a.S + q0 + wg * 64 + r) * a.Hq + h) * D + c * 8);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(__bfloat162float(e[u]) * sc);
    }
    *reinterpret_cast<uint4*>(sQ + (wg * PANELS + (c >> 3)) * PANEL + swz(r, c & 7)) = val;
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

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum
  float s[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = 0u;

  const uint64_t dq0 = make_desc(sQ_addr + wg * PANELS * PANEL, 16, 1024);
  // S = (q * scale) K^T of one tile: D / 16 steps of 16 over D; a step is 32
  // bytes inside a panel's 128-byte rows, and a second panel follows the first
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
        make_desc(stage0_addr + (tile % NSTAGE) * STAGE_BYTES + PANELS * KPANEL, KPANEL, 1024);
    fence_regs(p);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_pv<D>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
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
    for (int i = 0; i < D / 2; i += 4) {
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
// Streaming decode: one launch, a thread-block cluster per (streaming KV head,
// b) over the splits of its keys; a warp takes 16 keys at a time on mma.sync,
// a block merges its warps, and the cluster's leader merges the blocks
// ---------------------------------------------------------------------------

constexpr int ST_TILE = 16;  // keys a warp takes at a time: one k-step of the m16n8k16 P.V
constexpr int ST_MAX_WARPS = 8;
constexpr int ST_MAX_SPLITS = 8;  // blocks a cluster: the portable cluster size
constexpr int ST_MAX_G = 8;  // the rows of an m16n8k16 tile that hold a head (8-15 are zero)
// At D = 128 a warp's K rows are 320 bytes apart: the 16-byte fragment loads
// of a quarter-warp (rows gid and gid + 1, 16t + 64u bytes in) fall in 8
// distinct 16-byte bank groups. V rows are 272 bytes apart: the 8 row
// addresses of an ldmatrix phase do the same.
template <int D>
struct Stream {
  static constexpr int LDK = D + 32, LDV = D + 8;
  static constexpr int WARP_SMEM = ST_TILE * (LDK + LDV) * (int)sizeof(bf16);
  // After its walk a warp's output rows (float) take its K area, D + 8 floats
  // apart: a half-warp's float2 stores, (row gid, column 8j + 2t), hit 32 banks.
  static constexpr int ACC_LD = D + 8;
  static_assert(ST_MAX_G * ACC_LD * 4 <= ST_TILE * LDK * 2, "a warp's rows must fit in its K area");
  // A block's state in the leader's shared memory: acc [G][D], then m [8] and l [8]
  static __host__ __device__ constexpr int slot_floats(int G) { return G * D + 2 * ST_MAX_G; }
  static __host__ __device__ constexpr int smem_bytes(int warps, int nsplit, int G) {
    return warps * WARP_SMEM + nsplit * slot_floats(G) * (int)sizeof(float);
  }
};

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
template <int D>
__global__ void __launch_bounds__(32 * ST_MAX_WARPS) stream_decode_kernel(Args a) {
  constexpr int ST_LDK = Stream<D>::LDK, ST_LDV = Stream<D>::LDV, ST_WARP_SMEM = Stream<D>::WARP_SMEM;
  constexpr int ST_ACC_LD = Stream<D>::ACC_LD;
  constexpr int PPR = D / 8, RPI = 32 / PPR;  // 16-byte pieces a K or V row; rows a warp copies at once
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

  // The warp's 16 K and V rows of a tile, D / 8 lanes to a row; rows at or
  // past whi are zeros (0 * NaN in P.V would be NaN).
  bf16* sK = reinterpret_cast<bf16*>(smem + warp * ST_WARP_SMEM);
  bf16* sV = sK + ST_TILE * ST_LDK;
  const Rows src = rows_of<MODE_STREAM, D>(a, b, hk, keys.glo);
  auto issue = [&](int k0) {
#pragma unroll
    for (int u = 0; u < ST_TILE / RPI; ++u) {
      const int r = RPI * u + lane / PPR, c = lane % PPR, j = k0 + r;
      const bf16 *kp = a.k0, *vp = a.v0;
      int nbytes = 0;
      if (j < whi) {
        kv_row<MODE_STREAM, D>(src, j, kp, vp);
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
  uint32_t qa[D / 16][2];
  {
    const float sc = bf16_scale(a.scale);
    const uint4* qrow = reinterpret_cast<const uint4*>(a.q + ((size_t)b * a.Hq + hk * G + min(gid, G - 1)) * D) + tq;
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {  // channels 32u + 8t .. + 7: k-steps 2u and 2u + 1
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
    for (int u = 0; u < D / 32; ++u) {
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
  const int slot_floats = Stream<D>::slot_floats(G);
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

// ---------------------------------------------------------------------------
// Full-head decode: the keys of every (b, KV head) shared out evenly over a
// fixed grid; a block's warps take 16-key chunks in turn on mma.sync, and the
// block writes one partial a (b, KV head) it touches; a merge combines them
// ---------------------------------------------------------------------------

constexpr int DEC_TILE = 128;  // keys of a tile: the unit of the partition
constexpr int DEC_CHUNK = 16;  // keys a warp takes at a time: one k-step of the m16n8k16 P.V
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_STAGES = 3;  // chunks in a warp's ring: two in flight while one is multiplied
constexpr int DEC_MERGE_WAYS = 8;  // merge threads that share four columns, each taking every 8th partial

template <int D>
struct Decode {
  static constexpr int ROW = D * 2;  // bytes of a K or V row
  static constexpr int CHUNK_BYTES = 2 * DEC_CHUNK * ROW;  // the chunk's K rows, then its V rows
  static constexpr int WARP_BYTES = DEC_STAGES * CHUNK_BYTES;
  // After a segment's walk a warp's output rows (float) take its ring, D + 8
  // floats apart: a half-warp's float2 stores, (row gid, column 8j + 2t), hit 32 banks.
  static constexpr int ACC_LD = D + 8;
  static_assert(ST_MAX_G * ACC_LD * 4 <= WARP_BYTES, "a warp's rows must fit in its ring");
  // the warps' rings, then the rows' keys [B] and tile starts [B + 1]
  static __host__ __device__ constexpr int smem_bytes(int B) { return DEC_WARPS * WARP_BYTES + (2 * B + 1) * 4; }
};

// A decode partial: the G rows' unnormalized sums [G][D], then ST_MAX_G maxima
// and ST_MAX_G denominators (16-byte aligned for any G).
__host__ __device__ constexpr int decode_slot_floats(int G, int D) { return G * D + 2 * ST_MAX_G; }

// A chunk's rows are 16-byte pieces, swizzled so that the fragment loads meet
// no bank conflict with no padding: K piece c of row r sits at c ^ 4 (r & 1)
// (a quarter-warp's loads take rows gid and gid + 1 at pieces 4u + t), V
// piece c at c ^ (r & 7) (an ldmatrix phase takes 8 rows at one piece).
__device__ __forceinline__ int k_piece(int r, int c) { return c ^ ((r & 1) << 2); }
__device__ __forceinline__ int v_piece(int r, int c) { return c ^ (r & 7); }

// The keys a (b, KV head) pair of row b reads: min(cs + 1, bucket), none when
// the row has no query.
__device__ __forceinline__ int decode_row_keys(const Args& a, int b) {
  if (a.valid != nullptr && a.valid[b * a.valid_stride] <= 0) return 0;
  return max(min(a.cs[b * a.cs_stride] + 1, a.nkeys), 0);
}

// Every row's keys, and the tiles of one KV head of the rows before each
// (starts[B] is the total), into shared memory by a block-wide scan; ends at
// a barrier.
__device__ void decode_rows(const Args& a, int* keys, int* starts) {
  __shared__ int wsum[DEC_WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) starts[0] = 0;
  int carry = 0;
  for (int b0 = 0; b0 < a.B; b0 += DEC_THREADS) {
    const int b = b0 + tid;
    const int n = b < a.B ? decode_row_keys(a, b) : 0;
    int x = (n + DEC_TILE - 1) / DEC_TILE;  // inclusive scan of the tiles over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = carry;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      before += w < warp ? wsum[w] : 0;
      carry += wsum[w];
    }
    if (b < a.B) {
      keys[b] = n;
      starts[b + 1] = before + x;
    }
    __syncthreads();  // wsum is read before the next chunk of rows writes it
  }
}

// The tiles of one KV head of the rows before b, of row b and of every row,
// summed by each warp for itself.
__device__ __forceinline__ void decode_row_tiles(const Args& a, int b, int& before, int& mine, int& all) {
  const int lane = threadIdx.x & 31;
  before = mine = all = 0;
  for (int r = lane; r < a.B; r += 32) {
    const int n = (decode_row_keys(a, r) + DEC_TILE - 1) / DEC_TILE;
    before += r < b ? n : 0;
    mine += r == b ? n : 0;
    all += n;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(0xffffffffu, before, off);
    mine += __shfl_xor_sync(0xffffffffu, mine, off);
    all += __shfl_xor_sync(0xffffffffu, all, off);
  }
}

// Block p of `used` = min(nblocks, total tiles) takes tiles [p * total / used,
// (p + 1) * total / used) of the (b, KV head, tile) space; blocks past `used`
// have nothing. A share is cut into segments, one a (b, KV head) it touches:
// warp w takes chunks w, w + 4, ... of a segment through its ring, keeping
// its own online softmax of the G heads (row gid of the mma tiles); the block
// then merges its warps into the segment's partial.
template <int G, int D>
__global__ void __launch_bounds__(DEC_THREADS, 2) decode_kernel(Args a) {
  using Dc = Decode<D>;
  constexpr int PPR = D / 8, RPI = 32 / PPR;  // 16-byte pieces a row; rows a warp copies at once
  constexpr int SLOT = decode_slot_floats(G, D);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float wm[DEC_WARPS][G], wl[DEC_WARPS][G];
  int* keys = reinterpret_cast<int*>(smem + DEC_WARPS * Dc::WARP_BYTES);
  int* starts = keys + a.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tq = lane & 3;

  decode_rows(a, keys, starts);
  const long long total = (long long)a.Hkv * starts[a.B];
  const long long used = min((long long)a.nblocks, total);
  if (blockIdx.x >= used) return;
  long long t = blockIdx.x * total / used;
  const long long t1 = (blockIdx.x + 1) * total / used;
  unsigned char* ring = smem + warp * Dc::WARP_BYTES;
  const float sc = bf16_scale(a.scale);
  // V fragments: lane gives row (lane & 7) + 8 ((lane >> 3) & 1), piece 2jj + (lane >> 4)
  const int vr = (lane & 7) + 8 * ((lane >> 3) & 1);

  int b = 0;
  while (t < t1) {
    while ((long long)a.Hkv * starts[b + 1] <= t) ++b;  // the row of tile t (rows with no keys have no tile)
    const int nt = starts[b + 1] - starts[b];
    const int off = (int)(t - (long long)a.Hkv * starts[b]);
    const int hk = off / nt, tile0 = off % nt;
    const int ntiles = (int)min(t1 - t, (long long)(nt - tile0));
    t += ntiles;
    const int klo = tile0 * DEC_TILE, khi = min((tile0 + ntiles) * DEC_TILE, keys[b]);
    const int nch = (khi - klo + DEC_CHUNK - 1) / DEC_CHUNK;
    const int mine = nch > warp ? (nch - 1 - warp) / DEC_WARPS + 1 : 0;  // this warp's chunks

    const size_t bh = (size_t)b * a.Hkv + hk;
    const bf16* kbase = a.k0 + bh * a.T0 * D;
    const bf16* vbase = a.v0 + bh * a.T0 * D;
    // chunk i of this warp (keys klo + 16 (warp + 4i) on) into stage i % 3; rows at or past khi are zeros
    auto issue = [&](int i) {
      const int k0 = klo + DEC_CHUNK * (warp + DEC_WARPS * i);
      const uint32_t sk = smem_addr(ring + (i % DEC_STAGES) * Dc::CHUNK_BYTES), sv = sk + DEC_CHUNK * Dc::ROW;
#pragma unroll
      for (int u = 0; u < DEC_CHUNK / RPI; ++u) {
        const int r = RPI * u + lane / PPR, c = lane % PPR, j = k0 + r;
        const bool in = j < khi;
        cp_async16(sk + r * Dc::ROW + 16 * k_piece(r, c), in ? kbase + (size_t)j * D + c * 8 : a.k0, in ? 16 : 0);
        cp_async16(sv + r * Dc::ROW + 16 * v_piece(r, c), in ? vbase + (size_t)j * D + c * 8 : a.v0, in ? 16 : 0);
      }
    };
#pragma unroll
    for (int i = 0; i < DEC_STAGES - 1; ++i) {
      if (i < mine) issue(i);
      cp_async_commit();
    }

    // q rows of the group scaled in bf16, as A fragments (rows at or past G are 0)
    uint32_t qa[D / 16][2];
    {
      const uint4* qrow = reinterpret_cast<const uint4*>(a.q + ((size_t)b * a.Hq + hk * G + min(gid, G - 1)) * D) + tq;
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {  // channels 32u + 8t .. + 7: k-steps 2u and 2u + 1
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
    for (int i = 0; i < mine; ++i) {
      if (i + DEC_STAGES - 1 < mine) issue(i + DEC_STAGES - 1);
      cp_async_commit();
      cp_async_wait<DEC_STAGES - 1>();  // chunk i has landed
      __syncwarp();
      const int k0 = klo + DEC_CHUNK * (warp + DEC_WARPS * i);
      const unsigned char* sK = ring + (i % DEC_STAGES) * Dc::CHUNK_BYTES;
      const uint32_t sV = smem_addr(sK) + DEC_CHUNK * Dc::ROW;
      // S of keys k0 + 8nt + 2t + c: n-tile nt's B fragment is K row 8nt + gid
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = 8 * nt + gid;
          const uint4 kw = *reinterpret_cast<const uint4*>(sK + r * Dc::ROW + 16 * k_piece(r, 4 * u + tq));
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
          vis[nt][c] = k0 + 8 * nt + 2 * tq + c < khi;
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
        ldmatrix_x4_trans(sV + vr * Dc::ROW + 16 * v_piece(vr, 2 * jj + (lane >> 4)), b0, b1, b2, b3);
        mma_16816(o[2 * jj][0], o[2 * jj][1], pa0, pa2, b0, b1);
        mma_16816(o[2 * jj + 1][0], o[2 * jj + 1][1], pa0, pa2, b2, b3);
      }
      __syncwarp();  // every lane is done with this stage before a later issue refills it
    }
    cp_async_wait<0>();  // (only empty groups are left)
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);

    // The warp's state into its ring and wm/wl, then the block's into the segment's slot
    __syncwarp();
    float* wacc = reinterpret_cast<float*>(ring);
    if (mine > 0 && gid < G) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(wacc + gid * Dc::ACC_LD + 8 * j + 2 * tq) = make_float2(o[j][0], o[j][1]);
      if (tq == 0) {
        wm[warp][gid] = m;
        wl[warp][gid] = l;
      }
    }
    __syncthreads();
    const int nvw = min(DEC_WARPS, nch);  // warps that hold keys: the first nvw
    float* slot = a.part + ((size_t)blockIdx.x + bh) * SLOT;
    for (int i = tid; i < G * (D / 4); i += DEC_THREADS) {
      const int g = i / (D / 4), c4 = 4 * (i % (D / 4));
      float4 acc;
      float L, M;
      merge4<DEC_WARPS>(
          nvw, [&](int w, int which) { return which ? wl[w][g] : wm[w][g]; },
          [&](int w) {
            return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(smem + w * Dc::WARP_BYTES) +
                                                    g * Dc::ACC_LD + c4);
          },
          acc, L, M);
      *reinterpret_cast<float4*>(slot + g * D + c4) = acc;
      if (c4 == 0) {
        slot[G * D + g] = M;
        slot[G * D + ST_MAX_G + g] = L;
      }
    }
    __syncthreads();  // the rings and wm/wl are free for the next segment
  }
}

// out[b, h, :] from the partials of the blocks that touched (b, h's KV head),
// found from the lengths as decode_kernel cut them: the blocks whose shares
// hold the pair's first and last tile and all between, combined in block
// order (out = sum_p e^(m_p - M) acc_p / sum_p e^(m_p - M) l_p, M = max_p
// m_p). A pair with no key (its row has no query) has no partial: its row
// is 0.
template <int D>
__global__ void __launch_bounds__(DEC_MERGE_WAYS * (D / 4)) decode_merge_kernel(Args a) {
  constexpr int LANES = D / 4;  // a thread: four columns of the row, every DEC_MERGE_WAYS-th partial
  __shared__ float sm[DEC_MERGE_WAYS], sl[DEC_MERGE_WAYS];
  __shared__ __align__(16) float sacc[DEC_MERGE_WAYS][D];
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.G, g = h % a.G;
  const int way = threadIdx.x / LANES, c4 = 4 * (threadIdx.x % LANES);
  const int slot_floats = decode_slot_floats(a.G, D);
  int before, mine, all;
  decode_row_tiles(a, b, before, mine, all);
  float M = NEG_INF, L = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mine > 0) {
    const long long total = (long long)a.Hkv * all, used = min((long long)a.nblocks, total);
    const long long first = (long long)a.Hkv * before + (long long)hk * mine;
    const int p0 = (int)(((first + 1) * used - 1) / total), p1 = (int)(((first + mine) * used - 1) / total);
    const float* pair = a.part + ((size_t)b * a.Hkv + hk) * slot_floats;
    for (int p = p0 + way; p <= p1; p += DEC_MERGE_WAYS) {
      const float* s = pair + (size_t)p * slot_floats;
      const float ms = s[a.G * D + g], ls = s[a.G * D + ST_MAX_G + g];
      const float4 x = *reinterpret_cast<const float4*>(s + g * D + c4);
      const float mn = fmaxf(M, ms);
      const float wo = fast_exp2((M - mn) * LOG2E), ws = fast_exp2((ms - mn) * LOG2E);
      acc = make_float4(acc.x * wo + x.x * ws, acc.y * wo + x.y * ws, acc.z * wo + x.z * ws, acc.w * wo + x.w * ws);
      L = L * wo + ls * ws;
      M = mn;
    }
  }
  *reinterpret_cast<float4*>(&sacc[way][c4]) = acc;
  if (c4 == 0) {
    sm[way] = M;
    sl[way] = L;
  }
  __syncthreads();
  if (way != 0) return;
  merge4<DEC_MERGE_WAYS>(
      DEC_MERGE_WAYS, [&](int w, int which) { return which ? sl[w] : sm[w]; },
      [&](int w) { return *reinterpret_cast<const float4*>(&sacc[w][c4]); }, acc, L, M);
  const float inv = 1.f / (L == 0.f ? 1.f : L);  // no key at all: the row is 0
  *reinterpret_cast<uint2*>(a.out + ((size_t)b * a.Hq + h) * D + c4) =
      make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
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

template <int D>
int launch_stream_decode(const Args& a, int B, cudaStream_t stream) {
  static int configured = -1;  // the device the attribute was set on (a host call a launch saved)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != configured)
    err = cudaFuncSetAttribute(stream_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Stream<D>::smem_bytes(ST_MAX_WARPS, ST_MAX_SPLITS, ST_MAX_G));
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = dev;
  const int warps = min(ST_MAX_WARPS, a.split_keys / ST_TILE);
  return static_cast<int>(launch_ex(stream_decode_kernel<D>, dim3(a.nsplit, a.Hkv, B), dim3(32 * warps),
                                    Stream<D>::smem_bytes(warps, a.nsplit, a.G), a.nsplit, stream, a));
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device:
// a host call made when the device or a larger size first comes (`dev` and
// `size` keep what was set), never again for the same launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& dev, int& size) {
  int now = 0;
  cudaError_t err = cudaGetDevice(&now);
  if (err != cudaSuccess || (now == dev && bytes <= size)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    dev = now;
    size = bytes;
  }
  return err;
}

template <int D>
int launch_full_decode(const Args& a, cudaStream_t stream) {
  const int smem = Decode<D>::smem_bytes(a.B);
  cudaError_t err = cudaSuccess;
  switch (a.G) {
#define DUO_DECODE_CASE(NG)                                                              \
  case NG: {                                                                             \
    static int dev = -1, size = 0;                                                       \
    err = allow_smem(decode_kernel<NG, D>, smem, dev, size);                             \
    if (err != cudaSuccess) return static_cast<int>(err);                                \
    decode_kernel<NG, D><<<a.nblocks, DEC_THREADS, smem, stream>>>(a);                   \
    break;                                                                               \
  }
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
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<D><<<dim3(a.Hq, a.B), DEC_MERGE_WAYS * (D / 4), 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int D>
int launch_prefill(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(prefill_kernel<MODE, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Prefill<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
  prefill_kernel<MODE, D><<<grid, PF_THREADS, Prefill<D>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The head_dims the kernels are built for; any other is refused.
bool head_dim_ok(int head_dim) { return head_dim == 128 || head_dim == 64; }

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Floats of one full-head decode partial of a group of G query heads.
int decode_partial_floats(int G, int head_dim) { return decode_slot_floats(G, head_dim); }

// q [B, S, Hq, D]; k/v [B, Hkv, T, D] (already holding the chunk at
// [cs, cs+S)); cs [B] (or one value, cs_stride 0); out [B, S, Hq, D].
// Keys at or past `span` are never read. Decode (S == 1) only: valid [B] (or
// one value, valid_stride 0; null: every row), a row with none reads no key
// and gives 0; the keys are shared out over `nblocks` blocks, and `part` is
// scratch of (nblocks + B*Hkv)*decode_partial_floats(Hq/Hkv, D) floats.
int full_cache_attention(const void* q, const void* k, const void* v, const void* cs,
                         int cs_stride, const void* valid, int valid_stride, void* out, int B, int S,
                         int Hq, int Hkv, int T, int span, int head_dim, float scale, void* part,
                         int nblocks, void* stream) {
  if (!head_dim_ok(head_dim) || Hq % Hkv != 0 || span > T) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1 ? (Hq / Hkv > ST_MAX_G || nblocks < 1 || part == nullptr) : valid != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.k0 = static_cast<const bf16*>(k);
  a.v0 = static_cast<const bf16*>(v);
  a.cs = static_cast<const int*>(cs);
  a.cs_stride = cs_stride;
  a.valid = static_cast<const int*>(valid);
  a.valid_stride = valid_stride;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.T0 = T;
  a.nkeys = span;
  a.scale = scale;
  a.B = B;
  a.nblocks = nblocks;
  a.part = static_cast<float*>(part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return S == 1 ? launch_full_decode<64>(a, st) : launch_prefill<MODE_FULL, 64>(a, B, st);
  return S == 1 ? launch_full_decode<128>(a, st) : launch_prefill<MODE_FULL, 128>(a, B, st);
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
  if (!head_dim_ok(head_dim) || Hq % Hs != 0 || sink > Ts || R <= 0)
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
  if (head_dim == 64) return S == 1 ? launch_stream_decode<64>(a, B, st) : launch_prefill<MODE_STREAM, 64>(a, B, st);
  return S == 1 ? launch_stream_decode<128>(a, B, st) : launch_prefill<MODE_STREAM, 128>(a, B, st);
}

// One launch of an empty kernel over `blocks` blocks of `threads` threads, in
// clusters of `cluster` blocks (0: none): the launch floor.
int empty_kernel_launch(int blocks, int threads, int cluster, void* stream) {
  return static_cast<int>(
      launch_ex(empty_kernel, dim3(blocks), dim3(threads), 0, cluster, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
