// Paged-attention decode for Hopper (sm_90a), CUDA C++ with plain f32 FMA.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:97
// (paged_attention_tpu, Pallas body `_body`), float pages.  Same function:
// one new query per row, q (B,1,H,hd), attends over the K/V pages
// (NP,bs,KV,hd) that its block-table row (B,NB) int32 names, slots
// s <= index[b] valid (int32 cursor; the new token is already written at
// slot index[b]).  Scores are q·k with q pre-scaled by 1/sqrt(hd), then
// softcap·tanh(s/softcap), then the mask (NEG_INF = -1e30); online softmax
// in f32; the output is acc / max(l, 1e-30) in q's dtype.  GQA: the G = H/KV
// query heads of one kv head share every page read.  Pages past the cursor
// are never read (the TPU kernel DMAs them and skips only the math).
// q and the pages are f32 or bf16 independently (a bf16 pool under f32
// activations); both become f32 in registers.  Quantized pages (int8/fp8
// with scales) are not handled here: ROADMAP queue A item 10.
//
// Bound on the card: decode reads every live K/V byte once and does
// 4·hd FLOP per (head, token) against 2·hd·bytes of K/V per (kv head,
// token): about 0.5 FLOP per byte in f32, far below the H100's
// ~20 FLOP/byte f32 ridge.  It is bound by bytes.  At the timing shape
// (B=8, H=KV=12, hd=64, bs=16, cursors 575, f32) that is 28.3 MB, ~8.5 us
// at 3.35 TB/s.
//
// Design (flash-decoding).  A (B, KV) grid alone is 96 CTAs at B=8 on
// 132 SMs, too few to pull the card's bandwidth.  So the row's token range
// is split: pass 1 runs a (B, KV, n_split) grid, each CTA of 128 threads
// walks its share of the row's live tokens in tiles, reading its own
// block-table entries.  A token's K (then V) row is read by hd/VEC threads
// with 16-byte loads (VEC = 4 f32 or 8 bf16); partial dot products are
// reduced with warp shuffles; scores of a tile go to shared memory where one
// warp per query head updates the running max m and sum l; each thread
// keeps its slice of the accumulator for all G heads in registers.  At the
// end the token lanes' accumulators are summed in shared memory and the
// CTA writes a partial (m, l, acc[hd]) per head to an f32 workspace.  A
// split that starts past the cursor writes m = -1e30, l = 0.  Pass 2, a
// (B, H) grid of hd threads, merges the splits: M = max m_s,
// out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30).  The
// wrapper picks n_split so that B·KV·n_split is at least ~2x132 CTAs with
// at least one page per split.
//
// What the simple design leaves on the table: cp.async/TMA prefetch of the
// next tile's pages while this tile computes (here each load is waited
// for), packing several rows into one CTA when B·KV is already large, and
// fusing pass 2 into pass 1 with a last-CTA-done counter.  At the serving
// shape the two launches' fixed costs are of the order of the whole
// byte bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;     // 4 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;           // query heads per kv head
constexpr int TOK_PER_LANE = 4;   // tokens per token lane per tile
constexpr float NEG_INF = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Pass 1: grid (B, KV, n_split), NTHREADS threads; dynamic shared memory
// holds the token lanes' accumulators, TL * G * HD floats.
template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_split_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                   const KT* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ index, float* __restrict__ ws_m,
                   float* __restrict__ ws_l, float* __restrict__ ws_acc,
                   int H, int KV, int G, int bs, int NB, int tok_per_split,
                   int n_split, float softcap, float scale) {
  constexpr int VEC = Vec<KT>::N;
  constexpr int TPT = HD / VEC;              // threads per token row
  constexpr int TL = NTHREADS / TPT;         // token lanes
  constexpr int TILE = TL * TOK_PER_LANE;    // tokens per tile
  static_assert(TPT <= 32 && 32 % TPT == 0, "a token row within one warp");

  __shared__ float q_s[MAXG * HD];
  __shared__ float p_s[MAXG * TILE];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];
  extern __shared__ float red_s[];

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_tok = tid / TPT, d0 = (tid % TPT) * VEC;
  const int warp = tid / 32, lane = tid % 32;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;   // first q head

  const int start = split * tok_per_split;
  const int end = min(min(start + tok_per_split, index[b] + 1), NB * bs);
  if (start >= end) {             // nothing live in this split
    for (int i = tid; i < G * HD; i += NTHREADS)
      ws_acc[((head0 + i / HD) * n_split + split) * HD + i % HD] = 0.f;
    if (tid < G) {
      ws_m[(head0 + tid) * n_split + split] = NEG_INF;
      ws_l[(head0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * HD; i += NTHREADS)
    q_s[i] = to_f32(q[head0 * HD + i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  __syncthreads();

  const int* trow = table + (size_t)b * NB;
  const size_t slot_stride = (size_t)KV * HD;       // elements per slot
  const size_t head_off = (size_t)kvh * HD + d0;

  for (int t0 = start; t0 < end; t0 += TILE) {
    // Scores of this tile's tokens, softcapped and masked, into p_s.
#pragma unroll
    for (int j = 0; j < TOK_PER_LANE; ++j) {
      const int ti = lane_tok + j * TL;
      const int t = t0 + ti;
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
      if (t < end) {
        const size_t slot = (size_t)trow[t / bs] * bs + t % bs;
        float kv[VEC];
        load_vec(kp + slot * slot_stride + head_off, kv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) s = fmaf(q_s[g * HD + d0 + e], kv[e], s);
            part[g] = s;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {              // G is uniform: no divergence
#pragma unroll
          for (int off = TPT / 2; off > 0; off >>= 1)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
          if (tid % TPT == 0) {
            float s = part[g];
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            p_s[g * TILE + ti] = t < end ? s : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int i = lane; i < TILE; i += 32) mx = fmaxf(mx, p_s[g * TILE + i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < TILE; i += 32) {
        const float p = expf(p_s[g * TILE + i] - m_new);
        p_s[g * TILE + i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // Rescale, then accumulate P·V for this thread's tokens and dims.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float alpha = alpha_s[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < TOK_PER_LANE; ++j) {
      const int ti = lane_tok + j * TL;
      const int t = t0 + ti;
      if (t < end) {
        const size_t slot = (size_t)trow[t / bs] * bs + t % bs;
        float vv[VEC];
        load_vec(vp + slot * slot_stride + head_off, vv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float p = p_s[g * TILE + ti];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();              // p_s is rewritten by the next tile
  }

  // Sum the token lanes' accumulators and write this split's partials.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red_s[(lane_tok * G + g) * HD + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < TL; ++r) s += red_s[r * G * HD + i];
    ws_acc[((head0 + i / HD) * n_split + split) * HD + i % HD] = s;
  }
  if (tid < G) {
    ws_m[(head0 + tid) * n_split + split] = m_s[tid];
    ws_l[(head0 + tid) * n_split + split] = l_s[tid];
  }
}

// Pass 2: grid (B, H), HD threads; merges the splits of one (row, head).
template <typename QT, int HD>
__global__ void __launch_bounds__(HD)
paged_combine_kernel(const float* __restrict__ ws_m,
                     const float* __restrict__ ws_l,
                     const float* __restrict__ ws_acc, QT* __restrict__ out,
                     int H, int n_split) {
  const size_t row = (size_t)blockIdx.x * H + blockIdx.y;
  const int d = threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ws_m[row * n_split + s]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ws_m[row * n_split + s] - M);
    L = fmaf(ws_l[row * n_split + s], w, L);
    o = fmaf(ws_acc[(row * n_split + s) * HD + d], w, o);
  }
  store_f32(out + row * HD + d, o / fmaxf(L, 1e-30f));
}

template <typename QT, typename KT, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* index, void* out,
                   float* ws_m, float* ws_l, float* ws_acc, int B, int H,
                   int KV, int bs, int NB, int n_split, int tok_per_split,
                   float softcap, cudaStream_t stream) {
  constexpr int TL = NTHREADS / (HD / Vec<KT>::N);
  const int G = H / KV;
  const size_t smem = sizeof(float) * TL * G * HD;   // <= 32 KB at MAXG
  const float scale = 1.0f / sqrtf((float)HD);
  paged_split_kernel<QT, KT, HD><<<dim3(B, KV, n_split), NTHREADS, smem,
                                   stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), table, index, ws_m, ws_l, ws_acc, H, KV, G,
      bs, NB, tok_per_split, n_split, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<QT, HD><<<dim3(B, H), HD, 0, stream>>>(
      ws_m, ws_l, ws_acc, static_cast<QT*>(out), H, n_split);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const int* table, const int* index, void* out,
                        float* ws_m, float* ws_l, float* ws_acc, int B, int H,
                        int KV, int bs, int NB, int n_split,
                        int tok_per_split, float softcap, cudaStream_t st) {
  if (hd == 64)
    return launch<QT, KT, 64>(q, kp, vp, table, index, out, ws_m, ws_l,
                              ws_acc, B, H, KV, bs, NB, n_split,
                              tok_per_split, softcap, st);
  if (hd == 128)
    return launch<QT, KT, 128>(q, kp, vp, table, index, out, ws_m, ws_l,
                               ws_acc, B, H, KV, bs, NB, n_split,
                               tok_per_split, softcap, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  ws is an f32 workspace of
// B*H*n_split*(hd + 2) floats: m, then l, then acc.  Returns a cudaError_t
// (0 = both passes launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* index, void* out, void* ws,
                                   int B, int H, int KV, int hd, int bs,
                                   int NB, int n_split, int tok_per_split,
                                   int q_dtype, int kv_dtype, float softcap,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG ||
      bs <= 0 || NB <= 0 || n_split <= 0 || tok_per_split <= 0 ||
      (long long)n_split * tok_per_split < (long long)NB * bs ||
      q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_m = static_cast<float*>(ws);
  float* ws_l = ws_m + (size_t)B * H * n_split;
  float* ws_acc = ws_l + (size_t)B * H * n_split;
  const int* tbl = static_cast<const int*>(table);
  const int* idx = static_cast<const int*>(index);
#define PA_ARGS hd, q, k_pages, v_pages, tbl, idx, out, ws_m, ws_l, ws_acc, \
                B, H, KV, bs, NB, n_split, tok_per_split, softcap, st
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = dispatch_hd<float, float>(PA_ARGS);
  else if (q_dtype == 0)
    err = dispatch_hd<float, __nv_bfloat16>(PA_ARGS);
  else if (kv_dtype == 0)
    err = dispatch_hd<__nv_bfloat16, float>(PA_ARGS);
  else
    err = dispatch_hd<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
#undef PA_ARGS
  return (int)err;
}
