// Paged-attention decode for Hopper (sm_90a), CUDA C++ with plain f32 FMA:
// one launch a call, the splits of a row merged on chip in a thread-block
// cluster, K/V pages copied into shared memory by pipelined cp.async.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:97
// (paged_attention_tpu, `pl.pallas_call` at :148), float pages and the
// `quantized=True` body (dequant at :68-74).  Same function: one new query
// per row, q (B,1,H,hd), attends over the K/V pages (NP,bs,KV,hd) that its
// block-table row (B,NB) int32 names, slots s <= index[b] valid (the new
// token is already written at slot index[b]; the cursor is int32 or int64).
// Scores are q·k with q pre-scaled by 1/sqrt(hd), then
// softcap·tanh(s/softcap), then the mask (NEG_INF = -1e30); online softmax
// in f32; the output is acc / max(l, 1e-30) in q's dtype.  GQA: the
// G = H/KV query heads of one kv head, any G, share every page read.  q is f32
// or bf16, pages f32, bf16, int8 or fp8 e4m3; int8/fp8 pages come with one
// f32 scale per (slot, kv head) in scale pages (NP,bs,KV,1), read through
// the same table entry, and each value is dequantized in registers as
// float(x_q) * scale before it meets q or p.  Pages past the cursor are
// never read (the TPU kernel DMAs them and skips only the math).
//
// Bound on the card.  Decode reads every live K/V byte once and does
// 4·hd·G FLOP per (kv head, token) against 2·hd·bytes of K/V: 0.5 FLOP a
// byte over f32 pages and 2 over 1-byte pages at G = 1, far below the
// H100's ~20 FLOP/byte f32 ridge.  It is bound by bytes, so the tensor
// cores would buy nothing: scores and P·V stay in f32 FMA.  At the timing
// shape (B=8, H=KV=12, hd=64, bs=16, cursors 575) that is 28.4 MB, ~8.5 us
// at 3.35 TB/s, over f32 pages and 7.57 MB, ~2.3 us, over int8/fp8 pages.
//
// Design.
// 1. One launch, grid (n_split, KV, B).  The n_split <= 8 CTAs of one
//    (row, kv head) form a cluster (cudaLaunchKernelEx with
//    cudaLaunchAttributeClusterDimension (n_split, 1, 1)).  Each CTA reads
//    the row's cursor itself and takes its rank's share of the row's live
//    pages: the ceil(live / bs) pages split evenly, pages per rank
//    ceil(live pages / n_split), so a short row leaves the last ranks
//    empty and no rank reads past the cursor, whatever the table's width.
//    The wrapper chooses n_split (ops.split_plan): enough CTAs for about
//    two per SM, at most 8, at most NB, and 1 once B·KV alone reaches
//    that.  When B·KV·8 < 132 (B = KV = 1) the rest of the SMs idle.
// 2. The row's block table goes into shared memory once, up front, loaded
//    together with the cursor and q (pre-scaled, f32): one round trip of
//    setup, and no page address in the loop waits on a table load.  The
//    page of token t is found by a multiply with ceil(2^32 / bs) (exact
//    while NB·bs·bs < 2^32).
// 3. Each of the 4 warps walks every 4th tile of the CTA's range with its
//    own ring of STAGES = 3 stages in shared memory.  A tile is TW tokens
//    whose K rows (one kv head) make 2 KB, and their V rows another 2 KB:
//    8 f32 tokens at hd 64, 32 one-byte tokens.  K and V of a tile, and
//    for 1-byte pages their scales (4-byte copies per (slot, kv head)),
//    are issued together as one cp.async group, 16 bytes a copy for every
//    page dtype (16 one-byte values); rows past the range are zero-filled
//    and never read from global memory.  While a warp computes one tile
//    its next two are in flight: 8 KB a warp, 32 KB a CTA, and at the
//    timing shape's 288 CTAs over 132 SMs ~70 KB an SM, above the
//    ~25-32 KB that 3.35 TB/s at ~1 us of latency needs.  cp.async
//    rather than TMA: the rows are gathered through the table one token
//    at a time, which a tensor map cannot describe without one descriptor
//    per page, built on the host on a loop that is already host-bound.
//    Warps never wait for one another inside the loop: each keeps its own
//    online softmax (m, l, acc), and __syncwarp orders its copies and
//    reads.
// 4. Compute reads shared memory with its own lane mapping.  Scores: the
//    lanes of a token each take one 16-byte chunk of its K row (4..32
//    lanes a token), dot it with q for every head (held in registers at
//    G = 1, else read from shared memory, broadcast) and reduce with xor
//    shuffles; the tile's max is one more shuffle step over the tokens.
//    P·V: 4 dims a lane (16 lanes a token at hd 64, 32 at hd 128), the
//    weights broadcast from shared memory, so the accumulator is
//    acc[GM][4] whatever the page dtype.  GM, the heads a kernel carries,
//    is 1 for G = 1 and 8 for G = 2..8 (heads past G run on a zero q and
//    are dropped): no loop over heads branches, so the compiler
//    interleaves the tile's independent chains.  Reductions run in a fixed
//    order, so repeated calls give identical bits.
//    G > 8 (starcoder2-3b's 24 query heads over 2 kv heads: G = 12) takes
//    head blocks of 8 (MB): a warp runs the scores, softmax and P·V of
//    each block in turn over the tile it holds in shared memory, so the
//    pages are still read once for all G heads.  A GM = 16 accumulator
//    would not fit the registers beside the scores (GM = 8 already takes
//    ~130), so a block's running (m, l, acc) waits in shared memory
//    between tiles: the tile's P·V goes into a fresh acc, summed over the
//    token groups, and is folded in as acc · alpha + tile.  That costs
//    each block one 16-byte read and write of its acc a lane per tile and
//    the K dequantization once per block.  Shared memory bounds G: q, the
//    warps' and ranks' accumulators take 6·G·hd f32 beside the rings, so
//    over 1024 pages hd 128 serves G up to 54 and hd 64 up to 104; past
//    that cudaFuncSetAttribute refuses the launch and its error returns.
// 5. The merge on chip.  Each warp leaves (m, l, acc[G][hd]) in shared
//    memory and the CTA merges its 4 warps in warp order.  With n_split = 1
//    that is the output.  Otherwise rank r owns a fixed slice of the G·hd
//    outputs, and every CTA writes through distributed shared memory
//    (cluster.map_shared_rank) its (m, l) into every rank and each element
//    of its merged acc into the rank that owns it; after one cluster
//    barrier (arrive.release, wait.acquire) each rank merges its slice
//    from its own shared memory in rank order: M = max m,
//    L = sum l e^(m-M), out = sum acc e^(m-M) / max(L, 1e-30).  Writing
//    rather than reading the partials puts one cluster barrier and no
//    remote round trip on the critical path: no CTA touches another's
//    memory after the barrier, so none has to wait for the others before
//    it exits.  The barrier that makes every CTA of the cluster run before
//    the first remote write is split too: arrive after the setup, wait
//    after the loop.  No workspace, no second pass.
//
// Where the time goes at the timing shape (tools/paged_variants.py, its
// ablations and plan sweep, H100 80GB HBM3 at 700 W): ~5 us of a reading
// is launch and events (a one-thread kernel reads ~4.9-5.1 us), the setup
// round trip ~1.4 us, the merges ~1.4 us; the rest is the page reads, and
// for 1-byte pages ~1.6 (int8) to ~2.5 us (fp8) of dequantizing FMA after
// the last tile lands (issue-bound: 3-5 instructions a value).  One CTA
// per (row, kv head) reads ~5% faster with the L2 flushed (no merge) but
// ~20% slower warm over f32 pages, so the plan keeps ~2 CTAs per SM.
//
// What it leaves on the table: reading all kv heads of a slot in one CTA
// (a page row's 64-byte pieces now go to 12 CTAs at different times);
// several rows per CTA when B·KV far exceeds the card; a warp-specialised
// producer; the scale folded out of the dequantized products (kept as
// float(x_q) * scale per value, the reference's arithmetic).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int MAXG = 8;            // query heads a head block carries
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int STAGES = 3;          // ring depth of each warp
constexpr int TILE_BYTES = 2048;   // K bytes of a warp tile up to 512-byte rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Tile geometry of one instantiation: page dtype code KVC (0 f32, 1 bf16,
// 2 int8, 3 fp8 e4m3), head dim HD and heads a block carries GM (1 or 8).
// Rows of up to 512 bytes (every case at hd 64 and 128) take one 16-byte
// chunk a score lane and 4 P·V dims a lane, in tiles of TILE_BYTES.  hd
// 256 in f32 (1024-byte rows) takes two chunks a lane (CPL) in tiles of
// 4 tokens, 4 KB; at hd 256 a lane takes 8 P·V dims, so that a token's
// P·V lanes still fit one warp.
template <int KVC, int HD, int GM>
struct Shape {
  static constexpr int ES = KVC == 0 ? 4 : KVC == 1 ? 2 : 1;  // bytes
  static constexpr bool QUANT = KVC >= 2;
  static constexpr int ROW = HD * ES;           // one token's K row
  static constexpr int LPT = ROW / 16 < 32 ? ROW / 16 : 32;  // score lanes
  static constexpr int CPL = ROW / 16 / LPT;    // 16-byte chunks a lane
  static constexpr int TGS = 32 / LPT;          // tokens a score sub-step
  static constexpr int TB = ROW > 512 ? 4 * ROW : TILE_BYTES;  // K bytes
  static constexpr int TW = TB / ROW;           // tokens of a warp tile
  static constexpr int SUB = TW / TGS;          // score sub-steps a tile
  static constexpr int CW = 16 / ES;            // values a 16-byte chunk
  static constexpr int DPV = HD <= 128 ? 4 : HD / 32;   // P·V dims a lane
  static constexpr int LPV = HD / DPV;          // P·V lanes a token
  static constexpr int TGP = 32 / LPV;          // tokens a P·V step
  static constexpr int STAGE = 2 * TB + (QUANT ? 2 * TW * 4 : 0);
  static_assert(SUB == 4 && TW <= 32 && LPT <= 32 && TGP >= 1 &&
                    TW % TGP == 0 && DPV % 4 == 0, "tile");
};

// Heads of q held in shared memory (G padded to whole head blocks of GM)
// and the stride of the per-head (m, l) arrays: GM for G <= GM, where the
// heads past G run on a zero q, else G.
__host__ __device__ constexpr int q_heads(int G, int GM) {
  return (G + GM - 1) / GM * GM;
}
__host__ __device__ constexpr int head_stride(int G, int GM, bool MB) {
  return MB ? G : GM;
}

// Dynamic shared memory: the warps' rings, q (q_heads·HD f32), the warps'
// accumulators (4·G·HD f32), the ranks' parts of this CTA's output slice
// (G·HD + 8 f32), the warps' (m, l) and merge weights (3·4 per head), the
// ranks' (m, l) (2·8 per head), then the row's block table (NB ints).
template <int KVC, int HD, int GM, bool MB>
size_t smem_bytes(int G, int NB) {
  const size_t GS = head_stride(G, GM, MB);
  return (size_t)NWARPS * STAGES * Shape<KVC, HD, GM>::STAGE +
         ((size_t)(q_heads(G, GM) + (NWARPS + 1) * G) * HD + MAX_CLUSTER +
          (3 * NWARPS + 2 * MAX_CLUSTER) * GS) * sizeof(float) +
         (size_t)NB * sizeof(int);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The 4 / ES values of one 32-bit word of page data, exactly, as f32.
// int8: the byte offset by 128 goes into the mantissa of 2^23, and
// 2^23 + 128 is subtracted.  fp8 e4m3: sign, exponent and mantissa bits go
// where f32 keeps them and a product with 2^120 rebiases the exponent,
// subnormals included (the two NaN codes, which the quantizer never
// writes, read as ±480).
template <int KVC>
__device__ __forceinline__ void word_to_f32(uint32_t w, float* o) {
  if constexpr (KVC == 0) {
    o[0] = __uint_as_float(w);
  } else if constexpr (KVC == 1) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  } else if constexpr (KVC == 2) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
             8388736.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = (int)__byte_perm(w, 0u, 0x0444u | (i << 12));
      o[i] = __uint_as_float((uint32_t)(t >> 4) & 0x87F00000u) * 0x1p120f;
    }
  }
}

// N page values at p in shared memory (N·ES bytes, aligned to them) as f32.
template <int KVC, int N>
__device__ __forceinline__ void load_f32(const unsigned char* p, float* o) {
  constexpr int ES = KVC == 0 ? 4 : KVC == 1 ? 2 : 1;
  constexpr int BYTES = N * ES;
  constexpr int PER = 4 / ES;
  uint32_t w[BYTES / 4];
  if constexpr (BYTES == 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint4 u = *reinterpret_cast<const uint4*>(p + 16);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    w[4] = u.x; w[5] = u.y; w[6] = u.z; w[7] = u.w;
  } else if constexpr (BYTES == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    static_assert(BYTES == 4, "4, 8, 16 or 32 bytes");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int k = 0; k < BYTES / 4; ++k) word_to_f32<KVC>(w[k], o + k * PER);
}

// 2^x on the SFU (ex2.approx, ~2 ulp; -1e30·log2 e gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, or 16 zero bytes (nothing read) if !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// A cluster barrier split in two: arrive (relaxed: only "this CTA runs",
// or release: its stores so far) now, wait (acquire) later.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Scores of one tile's tokens for GM heads, softcapped and masked past t1:
// s[i][g] for token i·TGS + tg of the tile.  q is read from qb in shared
// memory (f32, pre-scaled), or for GM = 1 from the lane's chunk in q_reg.
template <int KVC, int HD, int GM>
__device__ __forceinline__ void tile_scores(
    float (&s)[Shape<KVC, HD, GM>::SUB][GM], const unsigned char* st,
    const float* qb,
    const float (&q_reg)[GM == 1 ? Shape<KVC, HD, GM>::CW *
                                       Shape<KVC, HD, GM>::CPL : 1],
    int tg, int col, int tbase, int t1, float softcap) {
  using S = Shape<KVC, HD, GM>;
  constexpr int LPT = S::LPT, TGS = S::TGS, SUB = S::SUB, CW = S::CW;
  constexpr int CPL = S::CPL;
  const float* k_scale = reinterpret_cast<const float*>(st + 2 * S::TB);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int r = i * TGS + tg;
    // The lane's chunks col, col + LPT, ... of the row, in that order.
    float k[CPL * CW];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      load_f32<KVC, CW>(st + r * S::ROW + (col + c * LPT) * 16, k + c * CW);
    if constexpr (S::QUANT) {
      const float sk = k_scale[r];
#pragma unroll
      for (int e = 0; e < CPL * CW; ++e) k[e] *= sk;
    }
    const bool valid = tbase + r < t1;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float dot = 0.f;
      if constexpr (GM == 1) {
#pragma unroll
        for (int e = 0; e < CPL * CW; ++e) dot = fmaf(q_reg[e], k[e], dot);
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float* qg = qb + g * HD + (col + c * LPT) * CW;
#pragma unroll
          for (int e = 0; e < CW; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qg + e);
            dot = fmaf(qq.x, k[c * CW + e], dot);
            dot = fmaf(qq.y, k[c * CW + e + 1], dot);
            dot = fmaf(qq.z, k[c * CW + e + 2], dot);
            dot = fmaf(qq.w, k[c * CW + e + 3], dot);
          }
        }
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(FULL, dot, off);
      if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
      s[i][g] = valid ? dot : NEG_INF;
    }
  }
}

// The token-group leaders (col 0) publish the tile's softmax weights s into
// the warp's p (p_s[warp]), token-major.
template <int KVC, int HD, int GM>
__device__ __forceinline__ void publish_p(
    float (*p)[GM], const float (&s)[Shape<KVC, HD, GM>::SUB][GM], int tg,
    int col) {
  using S = Shape<KVC, HD, GM>;
  if (col != 0) return;
#pragma unroll
  for (int i = 0; i < S::SUB; ++i) {
    float* dst = &p[i * S::TGS + tg][0];
    if constexpr (GM == 1) {
      dst[0] = s[i][0];
    } else {
#pragma unroll
      for (int g = 0; g < GM; g += 4)
        *reinterpret_cast<float4*>(dst + g) =
            make_float4(s[i][g], s[i][g + 1], s[i][g + 2], s[i][g + 3]);
    }
  }
}

// acc += P·V over the tile's tokens: the lane's DPV dims of its P·V token
// group, the weights broadcast from the warp's p.
template <int KVC, int HD, int GM>
__device__ __forceinline__ void tile_pv(
    float (&acc)[GM][Shape<KVC, HD, GM>::DPV], const unsigned char* st,
    const float (*p)[GM], int vt, int vc) {
  using S = Shape<KVC, HD, GM>;
  constexpr int TW = S::TW, DPV = S::DPV, TGP = S::TGP;
  const float* v_scale = reinterpret_cast<const float*>(st + 2 * S::TB) + TW;
#pragma unroll
  for (int jj = 0; jj < TW / TGP; ++jj) {
    const int r = jj * TGP + vt;
    float v[DPV];
    load_f32<KVC, DPV>(st + S::TB + r * S::ROW + vc * DPV * S::ES, v);
    if constexpr (S::QUANT) {
      const float sv = v_scale[r];
#pragma unroll
      for (int e = 0; e < DPV; ++e) v[e] *= sv;
    }
    float pr[GM];
    if constexpr (GM == 1) {
      pr[0] = p[r][0];
    } else {
#pragma unroll
      for (int g = 0; g < GM; g += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&p[r][g]);
        pr[g] = p4.x; pr[g + 1] = p4.y; pr[g + 2] = p4.z; pr[g + 3] = p4.w;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < DPV; ++e) acc[g][e] = fmaf(pr[g], v[e], acc[g][e]);
  }
}

// Grid (n_split, KV, B), cluster (n_split, 1, 1), NTHREADS threads.  GM is
// 1 (G = 1) or 8.  MB false (G <= 8): the heads past G run on a zero q and
// are dropped, so that no loop over the heads branches, and a warp keeps
// its (m, l, acc) in registers.  MB true (G > 8): a warp walks the G heads
// in head blocks of 8 over each tile it holds in shared memory, so every
// page is still read once for all G heads; a block's running (m, l, acc)
// waits in shared memory (part_m, part_l, part_acc) between tiles, and the
// heads past G of the last block are dropped.
// One CTA an SM is all the launch needs (minBlocks 1): without it ptxas
// capped the head-block entries at 96-128 registers and spilled.
template <typename QT, int KVC, int HD, int GM, bool MB>
__global__ void __launch_bounds__(NTHREADS, 1)
paged_decode_kernel(const QT* __restrict__ q,
                    const unsigned char* __restrict__ kp,
                    const unsigned char* __restrict__ vp,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ table, const void* index,
                    int index64, QT* __restrict__ out, int H, int KV, int G,
                    int bs, unsigned long long bs_magic, int NB,
                    float softcap, float scale) {
  using S = Shape<KVC, HD, GM>;
  constexpr int TW = S::TW, LPT = S::LPT, TGS = S::TGS, SUB = S::SUB;
  constexpr int CW = S::CW, DPV = S::DPV, LPV = S::LPV, CPL = S::CPL;
  constexpr int ROW = S::ROW, STAGE = S::STAGE, TB = S::TB;
  static_assert(!MB || GM > 1, "head blocks of GM > 1 heads");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float p_s[NWARPS][32][GM];   // softmax weights
  const int GS = head_stride(G, GM, MB), GQ = q_heads(G, GM);
  float* q_s = reinterpret_cast<float*>(smem + NWARPS * STAGES * STAGE);
  float* part_acc = q_s + GQ * HD;              // the warps' acc, G x HD each
  float* recv_acc = part_acc + NWARPS * G * HD; // the ranks' acc of my slice
  float* part_m = recv_acc + G * HD + MAX_CLUSTER;   // [warp * GS + g]
  float* part_l = part_m + NWARPS * GS;
  float* wt_s = part_l + NWARPS * GS;
  float* recv_m = wt_s + NWARPS * GS;                // [rank * GS + g]
  float* recv_l = recv_m + MAX_CLUSTER * GS;
  int* tbl_s = reinterpret_cast<int*>(recv_l + MAX_CLUSTER * GS);

  const int n_split = gridDim.x, rank = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The cursor, the row's block table and q, loaded at once.
  const long long cur = index64
                            ? static_cast<const long long*>(index)[b]
                            : (long long)static_cast<const int*>(index)[b];
  for (int i = tid; i < NB; i += NTHREADS)
    tbl_s[i] = table[(size_t)b * NB + i];
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  for (int i = tid; i < GQ * HD; i += NTHREADS)
    q_s[i] = i < G * HD ? to_f32(q[head0 * HD + i]) * scale : 0.f;
  if constexpr (MB) {            // every warp's running state, empty
    for (int i = tid; i < NWARPS * G; i += NTHREADS) {
      part_m[i] = NEG_INF;
      part_l[i] = 0.f;
    }
    for (int i = tid; i < NWARPS * G * HD; i += NTHREADS) part_acc[i] = 0.f;
  }
  // This rank's share of the row's live pages, and its tokens [t0, t1).
  const int live = (int)min(max(cur + 1, 0LL), (long long)NB * bs);
  const int live_pages = (live + bs - 1) / bs;
  const int pps = (live_pages + n_split - 1) / n_split;
  const int p0 = min(rank * pps, live_pages);
  const int p1 = min(p0 + pps, live_pages);
  const int t0 = p0 * bs, t1 = min(p1 * bs, live);
  // Every CTA of the cluster must run before any writes into another's
  // shared memory: arrive now, wait just before the first such write.
  if (n_split > 1) cluster_arrive_relaxed();
  __syncthreads();

  // Slot of token t (t < live) in the pool.
  auto slot_of = [&](int t) -> size_t {
    const int pg = (int)(((unsigned long long)(unsigned)t * bs_magic) >> 32);
    return (size_t)tbl_s[pg] * bs + (t - pg * bs);
  };

  unsigned char* ring = smem + warp * STAGES * STAGE;
  const int n_tiles = (max(t1 - t0, 0) + TW - 1) / TW;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + NWARPS - 1) / NWARPS
                                      : 0;
  const int tg = lane / LPT, col = lane % LPT;   // score mapping
  const int vt = lane / LPV, vc = lane % LPV;    // P·V mapping
  float q_reg[GM == 1 ? CPL * CW : 1];           // G = 1: q's chunks held
  if constexpr (GM == 1) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        q_reg[c * CW + e] = q_s[(col + c * LPT) * CW + e];
  }

  // Tile j of this warp (the CTA's tile warp + 4j) into ring slot j % STAGES.
  auto issue = [&](int j) {
    unsigned char* st = ring + (j % STAGES) * STAGE;
    const int tbase = t0 + (warp + NWARPS * j) * TW;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int r = i * TGS + tg, t = tbase + r;
      const bool ok = t < t1;
      const size_t row = ok ? (slot_of(t) * KV + kvh) * ROW : 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int b = (col + c * LPT) * 16;
        cp_async16(st + r * ROW + b, kp + row + b, ok);
        cp_async16(st + TB + r * ROW + b, vp + row + b, ok);
      }
    }
    if constexpr (S::QUANT) {
      if (lane < TW) {
        const int t = tbase + lane;
        const bool ok = t < t1;
        const size_t si = ok ? slot_of(t) * KV + kvh : 0;
        float* sc = reinterpret_cast<float*>(st + 2 * TB);
        cp_async4(sc + lane, ks + si, ok);
        cp_async4(sc + TW + lane, vs + si, ok);
      }
    }
  };

  float acc[MB ? 1 : GM][DPV], m[MB ? 1 : GM], l[MB ? 1 : GM];
  if constexpr (!MB) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < DPV; ++e) acc[g][e] = 0.f;
    }
  }

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < my_tiles) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < my_tiles; ++j) {
    if (j + STAGES - 1 < my_tiles) issue(j + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const unsigned char* st = ring + (j % STAGES) * STAGE;
    const int tbase = t0 + (warp + NWARPS * j) * TW;

    if constexpr (!MB) {
      // Scores of the tile's tokens for every head, then the online
      // softmax: s becomes p; the token-group leaders keep l and publish p.
      float s[SUB][GM];
      tile_scores<KVC, HD, GM>(s, st, q_s, q_reg, tg, col, tbase, t1,
                               softcap);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = fmaxf(fmaxf(s[0][g], s[1][g]), fmaxf(s[2][g], s[3][g]));
#pragma unroll
        for (int off = 16; off >= LPT; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = ex2((m[g] - m_new) * LOG2E);
        m[g] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          s[i][g] = ex2((s[i][g] - m_new) * LOG2E);
          sum += s[i][g];
        }
        l[g] = l[g] * alpha + (col == 0 ? sum : 0.f);
#pragma unroll
        for (int e = 0; e < DPV; ++e) acc[g][e] *= alpha;
      }
      publish_p<KVC, HD, GM>(p_s[warp], s, tg, col);
      __syncwarp();
      tile_pv<KVC, HD, GM>(acc, st, p_s[warp], vt, vc);
      __syncwarp();               // the slot and p_s are rewritten next
    } else {
      // Head block by head block over the same tile in shared memory.  The
      // block's (m, l) are warp-uniform; the tile's P·V goes into a fresh
      // acc, summed over the token groups and folded into the block's
      // running acc in shared memory as acc · alpha + tile.
#pragma unroll 1
      for (int h0 = 0; h0 < GQ; h0 += GM) {
        float s[SUB][GM];
        tile_scores<KVC, HD, GM>(s, st, q_s + h0 * HD, q_reg, tg, col, tbase,
                                 t1, softcap);
        float m_new[GM], l_new[GM], alpha[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float mx = fmaxf(fmaxf(s[0][g], s[1][g]), fmaxf(s[2][g], s[3][g]));
#pragma unroll
          for (int off = 16; off >= LPT; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
          const bool head = h0 + g < G;
          const float m_old = head ? part_m[warp * G + h0 + g] : NEG_INF;
          const float l_old = head ? part_l[warp * G + h0 + g] : 0.f;
          m_new[g] = fmaxf(m_old, mx);
          alpha[g] = ex2((m_old - m_new[g]) * LOG2E);
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < SUB; ++i) {
            s[i][g] = ex2((s[i][g] - m_new[g]) * LOG2E);
            sum += s[i][g];
          }
#pragma unroll
          for (int off = 16; off >= LPT; off >>= 1)
            sum += __shfl_xor_sync(FULL, sum, off);
          l_new[g] = l_old * alpha[g] + sum;
        }
        __syncwarp();             // every lane has read the block's (m, l)
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < GM; ++g)
            if (h0 + g < G) {
              part_m[warp * G + h0 + g] = m_new[g];
              part_l[warp * G + h0 + g] = l_new[g];
            }
        }
        publish_p<KVC, HD, GM>(p_s[warp], s, tg, col);
        __syncwarp();             // p published
        float tile[GM][DPV];
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < DPV; ++e) tile[g][e] = 0.f;
        tile_pv<KVC, HD, GM>(tile, st, p_s[warp], vt, vc);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
#pragma unroll
          for (int off = 16; off >= LPV; off >>= 1)
#pragma unroll
            for (int e = 0; e < DPV; ++e)
              tile[g][e] += __shfl_xor_sync(FULL, tile[g][e], off);
          if (h0 + g < G && lane < LPV) {
#pragma unroll
            for (int e = 0; e < DPV; e += 4) {
              float4* a = reinterpret_cast<float4*>(
                  &part_acc[(warp * G + h0 + g) * HD + vc * DPV + e]);
              float4 o = *a;
              o.x = fmaf(o.x, alpha[g], tile[g][e]);
              o.y = fmaf(o.y, alpha[g], tile[g][e + 1]);
              o.z = fmaf(o.z, alpha[g], tile[g][e + 2]);
              o.w = fmaf(o.w, alpha[g], tile[g][e + 3]);
              *a = o;
            }
          }
        }
        __syncwarp();             // p_s and the state are rewritten next
      }
    }
  }

  if constexpr (!MB) {
    // The warp's partial state: l summed over the leaders, acc over the
    // P·V token groups (xor butterflies: every lane ends with the same
    // bits).
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int off = 16; off >= LPV; off >>= 1)
#pragma unroll
        for (int e = 0; e < DPV; ++e)
          acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
      if (g < G && lane < LPV) {
#pragma unroll
        for (int e = 0; e < DPV; e += 4)
          *reinterpret_cast<float4*>(
              &part_acc[(warp * G + g) * HD + vc * DPV + e]) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                          acc[g][e + 3]);
      }
      if (lane == 0) {
        part_m[warp * GS + g] = m[g];
        part_l[warp * GS + g] = l[g];
      }
    }
  }
  __syncthreads();

  // The CTA's state, its warps merged in warp order.  With n_split = 1 it
  // is the output.  Otherwise each CTA pushes its (m, l) to every rank and
  // each element of its acc to the rank that owns that element (rank o
  // owns elements [o·per, (o+1)·per) of the G·HD outputs), into their
  // shared memory; after one cluster barrier each rank merges its slice in
  // rank order from its own shared memory.
  const int E = G * HD, per = (E + n_split - 1) / n_split;
  cg::cluster_group cluster = cg::this_cluster();
  if (n_split > 1) cluster_wait();
  for (int g = tid; g < G; g += NTHREADS) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, part_m[w * GS + g]);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      wt_s[w * GS + g] = ex2((part_m[w * GS + g] - M) * LOG2E);
      L = fmaf(part_l[w * GS + g], wt_s[w * GS + g], L);
    }
    if (n_split == 1) recv_l[g] = L;
    for (int r = 0; r < n_split && n_split > 1; ++r) {
      *cluster.map_shared_rank(&recv_m[rank * GS + g], r) = M;
      *cluster.map_shared_rank(&recv_l[rank * GS + g], r) = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += NTHREADS) {
    const int g = e / HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      o = fmaf(part_acc[w * G * HD + e], wt_s[w * GS + g], o);
    if (n_split == 1) {
      store_f32(out + head0 * HD + e, o / fmaxf(recv_l[g], 1e-30f));
    } else {
      const int own = e / per;
      *cluster.map_shared_rank(&recv_acc[rank * per + e - own * per], own) = o;
    }
  }
  if (n_split == 1) return;       // the whole cluster: uniform
  cluster_arrive_release();
  cluster_wait();
  const int e0 = min(rank * per, E), e1 = min(e0 + per, E);
  for (int e = e0 + tid; e < e1; e += NTHREADS) {
    const int g = e / HD;
    float M = NEG_INF;
    for (int r = 0; r < n_split; ++r) M = fmaxf(M, recv_m[r * GS + g]);
    float L = 0.f, o = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float wt = ex2((recv_m[r * GS + g] - M) * LOG2E);
      L = fmaf(recv_l[r * GS + g], wt, L);
      o = fmaf(recv_acc[r * per + e - e0], wt, o);
    }
    store_f32(out + head0 * HD + e, o / fmaxf(L, 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int* table;
  const void* index;
  int index64;
  void* out;
  int B, H, KV, G, bs, NB, n_split;
  unsigned long long bs_magic;
  float softcap;
  cudaStream_t stream;
  int* max_clusters;    // non-null: report the occupancy, launch nothing
};

template <typename QT, int KVC, int HD, int GM, bool MB>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<KVC, HD, GM, MB>(a.G, a.NB);
  auto kern = paged_decode_kernel<QT, KVC, HD, GM, MB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.KV, a.B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = a.n_split > 1 || a.max_clusters != nullptr ? 1 : 0;
  if (a.max_clusters != nullptr)
    err = cudaOccupancyMaxActiveClusters(a.max_clusters, kern, &cfg);
  else
    err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const QT*>(a.q),
      static_cast<const unsigned char*>(a.kp),
      static_cast<const unsigned char*>(a.vp), a.ks, a.vs, a.table, a.index,
      a.index64, static_cast<QT*>(a.out), a.H, a.KV, a.G, a.bs, a.bs_magic,
      a.NB, a.softcap, 1.0f / sqrtf((float)HD));
  if (err != cudaSuccess) cudaGetLastError();   // leave no error behind
  return err;
}

// G = 1, G = 2..8 (one head block), G > 8 (head blocks of 8 a tile).
template <typename QT, int KVC, int HD>
cudaError_t dispatch_g(const Args& a) {
  if (a.G == 1) return launch<QT, KVC, HD, 1, false>(a);
  if (a.G <= MAXG) return launch<QT, KVC, HD, MAXG, false>(a);
  return launch<QT, KVC, HD, MAXG, true>(a);
}

template <typename QT, int KVC>
cudaError_t dispatch_hd(int hd, const Args& a) {
  if (hd == 64) return dispatch_g<QT, KVC, 64>(a);
  if (hd == 128) return dispatch_g<QT, KVC, 128>(a);
  if (hd == 256) return dispatch_g<QT, KVC, 256>(a);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, int hd, const Args& a) {
  switch (kv_dtype) {
    case 0: return dispatch_hd<QT, 0>(hd, a);
    case 1: return dispatch_hd<QT, 1>(hd, a);
    case 2: return dispatch_hd<QT, 2>(hd, a);
    case 3: return dispatch_hd<QT, 3>(hd, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8, 3 = fp8 e4m3; the 1-byte codes take f32 scale pages k_scales,
// v_scales (NP, bs, KV, 1), which the float codes must leave null.  table
// is int32 (B, NB); index is (B,) int32 (index_dtype 0) or int64 (1).
// n_split is the cluster size, 1..8.  Returns the launch's cudaError_t
// (0 = launched; a refused launch leaves no error state behind).  With
// max_clusters non-null nothing is launched: it receives how many clusters
// of this launch the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales, const void* table,
                                   const void* index, void* out, int B, int H,
                                   int KV, int hd, int bs, int NB,
                                   int n_split, int q_dtype, int kv_dtype,
                                   int index_dtype, float softcap,
                                   void* stream, int* max_clusters) {
  const bool quant = kv_dtype == 2 || kv_dtype == 3;
  if (B <= 0 || B > 65535 || H <= 0 || KV <= 0 || KV > 65535 ||
      H % KV != 0 || bs <= 0 || NB <= 0 || n_split < 1 ||
      n_split > MAX_CLUSTER ||
      (unsigned long long)NB * bs * bs >= (1ull << 32) || q_dtype < 0 ||
      q_dtype > 1 || kv_dtype < 0 || kv_dtype > 3 || index_dtype < 0 ||
      index_dtype > 1 || quant != (k_scales != nullptr) ||
      quant != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.table = static_cast<const int*>(table);
  a.index = index;
  a.index64 = index_dtype;
  a.out = out;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.bs = bs;
  a.NB = NB;
  a.n_split = n_split;
  a.bs_magic = ((1ull << 32) + bs - 1) / bs;   // ceil(2^32 / bs)
  a.softcap = softcap;
  a.stream = static_cast<cudaStream_t>(stream);
  a.max_clusters = max_clusters;
  const cudaError_t err = q_dtype == 0
                              ? dispatch_kv<float>(kv_dtype, hd, a)
                              : dispatch_kv<__nv_bfloat16>(kv_dtype, hd, a);
  return (int)err;
}
