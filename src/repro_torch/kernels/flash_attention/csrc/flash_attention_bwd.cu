// Flash attention backward for Hopper (sm_90a), CUDA C++ with plain f32 FMA.
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention
// automatically (there is no custom_vjp anywhere in src/repro), so this is
// the gradient that training in PyTorch needs of the forward kernel in
// flash_attention.cu, which ports
// src/repro/kernels/flash_attention/kernel.py:flash_attention_tpu.
//
// Function: given q (B,S,H,hd), k/v (B,S,KV,hd), the forward's output o and
// per-row logsumexp lse (B,H,S) f32, and the upstream gradient dO, return
// dq, dk, dv.  With s = (q/sqrt(hd))·k, x = softcap·tanh(s/softcap) (or s),
// masked entries at NEG_INF:
//   P  = exp(x - lse)                      (recomputed, never stored)
//   D  = rowsum(dO ∘ o)                    (pass 1)
//   dV = Pᵀ dO,   dP = dO Vᵀ,   dX = P ∘ (dP - D)
//   dS = dX ∘ (1 - (x/softcap)²)           (the softcap's derivative)
//   dQ = dS K / sqrt(hd),   dK = dSᵀ (q/sqrt(hd))
// Causal, window, softcap, MHA/GQA, hd 64/128, f32/bf16 and ragged S as the
// forward takes them.
//
// Design: three launches, deterministic, no atomics.
//   1. dsum: one warp per (b, s, h) row computes D.
//   2. dkdv: grid (ceil(S/64), KV, B).  A CTA owns 64 keys of one kv head,
//      holds their K and V tiles in shared memory and dK, dV in registers,
//      and loops over the G = H/KV query heads of its group and over the
//      query tiles that can see its keys, so GQA sums inside the CTA.
//   3. dq: grid (ceil(S/64), H, B).  A CTA owns 64 query rows of one head,
//      holds Q, dO, lse and D, and loops over the key tiles it can see
//      (late causal tiles issued first, as in the forward).
// Tiles are 64x64 and every CTA has 256 threads in a 16x16 grid: thread
// (ty, tx) computes scores for rows ty+16a and columns tx+16c as 4x4 f32
// register micro-tiles (float4 reads over hd), and owns output rows ty+16a
// at columns 4tx..4tx+3 (+64) of its dK/dV/dQ accumulators.  P and dS go
// through shared memory between the two layouts.  Ragged tiles are masked;
// the caller pads nothing.
//
// Bound on the card: at the training shape (B=16, S=256, H=12, hd=64,
// causal, f32) the minimal backward is five 64-wide products per visible
// (query, key) pair (S, dP, dV, dQ, dK: 2.5x the forward's two),
// 10·B·H·hd·S(S+1)/2 ≈ 4.0 GFLOP, ≈ 60 us at 67 TFLOP/s f32, against
// ≈ 44 MB of q, k, v, o, dO, lse, dq, dk, dv at 3.35 TB/s ≈ 13 us: bound by
// f32 operations.  This design recomputes S and dP in both the dkdv and the
// dq pass (seven products per pair instead of five) to stay free of atomics.
//
// What the simple design leaves on the table: tensor cores (wgmma on bf16
// or TF32 operands), TMA and a double-buffered Q/dO ring in the dkdv pass,
// one fused pass with an atomic or split-buffer dQ, and a persistent
// schedule.

#include "flash_common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int PSTR = BK + 4;    // P / dS tiles: float4 rows, 4-float pad

// out[a][c] = X[ty + 16a] · Y[tx + 16c] over HD (rows of two shared tiles).
template <int HD, int STR>
__device__ __forceinline__ void tile_dots(float (&out)[4][4], const float* X,
                                          const float* Y, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      xv[a] = *reinterpret_cast<const float4*>(X + (ty + 16 * a) * STR + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      yv[c] = *reinterpret_cast<const float4*>(Y + (tx + 16 * c) * STR + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = out[a][c];
        s = fmaf(xv[a].x, yv[c].x, s);
        s = fmaf(xv[a].y, yv[c].y, s);
        s = fmaf(xv[a].z, yv[c].z, s);
        s = fmaf(xv[a].w, yv[c].w, s);
        out[a][c] = s;
      }
  }
}

__device__ __forceinline__ float lane4(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[a][4g+e] += sum_j W[ty+16a][j] * M[j][64g + 4tx + e]   (W 64x64)
template <int HD, int STR>
__device__ __forceinline__ void acc_rows(float (&acc)[4][HD / 16],
                                         const float* W, const float* M,
                                         int ty, int tx) {
  constexpr int NC = HD / 64;
#pragma unroll 2
  for (int j = 0; j < BK; j += 4) {
    float4 wv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      wv[a] = *reinterpret_cast<const float4*>(W + (ty + 16 * a) * PSTR + j);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 mv = *reinterpret_cast<const float4*>(
            M + (j + e) * STR + 64 * g + 4 * tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w = lane4(wv[a], e);
          acc[a][4 * g + 0] = fmaf(w, mv.x, acc[a][4 * g + 0]);
          acc[a][4 * g + 1] = fmaf(w, mv.y, acc[a][4 * g + 1]);
          acc[a][4 * g + 2] = fmaf(w, mv.z, acc[a][4 * g + 2]);
          acc[a][4 * g + 3] = fmaf(w, mv.w, acc[a][4 * g + 3]);
        }
      }
  }
}

// acc[a][4g+e] += sum_i W[i][ty+16a] * M[i][64g + 4tx + e]   (Wᵀ times M)
template <int HD, int STR>
__device__ __forceinline__ void acc_cols(float (&acc)[4][HD / 16],
                                         const float* W, const float* M,
                                         int ty, int tx) {
  constexpr int NC = HD / 64;
#pragma unroll 4
  for (int i = 0; i < BQ; ++i) {
    float w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) w[a] = W[i * PSTR + ty + 16 * a];
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 mv = *reinterpret_cast<const float4*>(
          M + i * STR + 64 * g + 4 * tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][4 * g + 0] = fmaf(w[a], mv.x, acc[a][4 * g + 0]);
        acc[a][4 * g + 1] = fmaf(w[a], mv.y, acc[a][4 * g + 1]);
        acc[a][4 * g + 2] = fmaf(w[a], mv.z, acc[a][4 * g + 2]);
        acc[a][4 * g + 3] = fmaf(w[a], mv.w, acc[a][4 * g + 3]);
      }
    }
  }
}

// P and dS of one 64x64 (query, key) tile from the scores s and dP, stored
// row-major [query][key] into Ps and dSs.  Thread (ty, tx) holds query rows
// ty+16a and keys tx+16c.
__device__ __forceinline__ void probs_and_grads(
    const float (&s)[4][4], const float (&dp)[4][4], const float* lse_s,
    const float* d_s, float* Ps, float* dSs, int q0, int k0, int S,
    int causal, int window, float softcap, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int qi = q0 + r;
    const float lse_i = lse_s[r];
    const float d_i = d_s[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ki = k0 + tx + 16 * c;
      float x = s[a][c];
      float deriv = 1.f;
      if (softcap > 0.f) {
        x = softcap * tanhf(x / softcap);
        const float t = x / softcap;
        deriv = 1.f - t * t;
      }
      bool ok = qi < S && ki < S;
      if (causal) ok = ok && (qi >= ki);
      if (window > 0) ok = ok && (qi - ki < window);
      const float p = ok ? expf(x - lse_i) : 0.f;
      Ps[r * PSTR + tx + 16 * c] = p;
      dSs[r * PSTR + tx + 16 * c] = p * (dp[a][c] - d_i) * deriv;
    }
  }
}

// lse and D of query rows q0..q0+63 of one head into shared memory
// (0 past S: those rows are masked).
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const float* lse_row,
                                          const float* d_row, int q0, int S) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < S ? lse_row[qi] : 0.f;
    d_s[threadIdx.x] = qi < S ? d_row[qi] : 0.f;
  }
}

template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[4][HD / 16],
                                           int row0, int S, int row_stride,
                                           float scale, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty + 16 * a;
    if (r >= S) continue;
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
      store4(base + (size_t)r * row_stride + 64 * g + 4 * tx,
             make_float4(acc[a][4 * g + 0] * scale, acc[a][4 * g + 1] * scale,
                         acc[a][4 * g + 2] * scale, acc[a][4 * g + 3] * scale));
  }
}

// D[b, h, s] = sum_d dO[b, s, h, d] * o[b, s, h, d]; one warp per row.
template <int HD, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ dsum, int S, int H, long long rows) {
  const long long r = (long long)blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;                 // whole warps leave together
  const T* orow = o + r * HD;
  const T* drow = dout + r * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = r % H;
    const long long s = (r / H) % S;
    const long long b = r / ((long long)H * S);
    dsum[(b * H + h) * S + s] = acc;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, int causal,
                      int window, float softcap, float scale) {
  constexpr int STR = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // [BK][STR]
  float* Vs = Ks + BK * STR;             // [BK][STR]
  float* Qs = Vs + BK * STR;             // [BQ][STR], pre-scaled
  float* dOs = Qs + BQ * STR;            // [BQ][STR]
  float* Ps = dOs + BQ * STR;            // [BQ][PSTR]
  float* dSs = Ps + BQ * PSTR;           // [BQ][PSTR]
  float* lse_s = dSs + BQ * PSTR;        // [BQ]
  float* d_s = lse_s + BQ;               // [BQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;        // low key tiles see the most queries
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int q_stride = H * HD;
  const int kv_stride = KV * HD;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * HD;

  load_tile<HD, STR>(Ks, k + kv_off, k0, S, kv_stride, 1.f);
  load_tile<HD, STR>(Vs, v + kv_off, k0, S, kv_stride, 1.f);

  // Query tiles that can see keys k0..min(k0+63, S-1).
  const int nq = (S + BQ - 1) / BQ;
  const int qt_begin = causal ? k0 / BQ : 0;
  int qt_end = nq - 1;
  if (window > 0) qt_end = min(qt_end, (min(k0 + BK - 1, S - 1) + window - 1) / BQ);

  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const size_t q_off = (size_t)b * S * q_stride + (size_t)h * HD;
    const float* lse_row = lse + ((size_t)b * H + h) * S;
    const float* d_row = dsum + ((size_t)b * H + h) * S;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int q0 = qt * BQ;
      load_tile<HD, STR>(Qs, q + q_off, q0, S, q_stride, scale);
      load_tile<HD, STR>(dOs, dout + q_off, q0, S, q_stride, 1.f);
      load_rows(lse_s, d_s, lse_row, d_row, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dots<HD, STR>(s, Qs, Ks, ty, tx);
      tile_dots<HD, STR>(dp, dOs, Vs, ty, tx);
      probs_and_grads(s, dp, lse_s, d_s, Ps, dSs, q0, k0, S, causal, window,
                      softcap, ty, tx);
      __syncthreads();
      acc_cols<HD, STR>(dv_acc, Ps, dOs, ty, tx);     // dV += Pᵀ dO
      acc_cols<HD, STR>(dk_acc, dSs, Qs, ty, tx);     // dK += dSᵀ (q·scale)
      __syncthreads();
    }
  }
  store_rows<HD>(dk + kv_off, dk_acc, k0, S, kv_stride, 1.f, ty, tx);
  store_rows<HD>(dv + kv_off, dv_acc, k0, S, kv_stride, 1.f, ty, tx);
}

template <int HD, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq, int S,
                    int H, int KV, int causal, int window, float softcap,
                    float scale) {
  constexpr int STR = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [BQ][STR], pre-scaled
  float* dOs = Qs + BQ * STR;            // [BQ][STR]
  float* Ks = dOs + BQ * STR;            // [BK][STR]
  float* Vs = Ks + BK * STR;             // [BK][STR]
  float* dSs = Vs + BK * STR;            // [BQ][PSTR]
  float* Ps = dSs + BQ * PSTR;           // [BQ][PSTR] (written, not read)
  float* lse_s = Ps + BQ * PSTR;         // [BQ]
  float* d_s = lse_s + BQ;               // [BQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int q_stride = H * HD;
  const int kv_stride = KV * HD;
  const size_t q_off = (size_t)b * S * q_stride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * HD;

  load_tile<HD, STR>(Qs, q + q_off, q0, S, q_stride, scale);
  load_tile<HD, STR>(dOs, dout + q_off, q0, S, q_stride, 1.f);
  load_rows(lse_s, d_s, lse + ((size_t)b * H + h) * S,
            dsum + ((size_t)b * H + h) * S, q0, S);

  int k_hi = S - 1;
  if (causal) k_hi = min(k_hi, q0 + BQ - 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float dq_acc[4][HD / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dq_acc[a][c] = 0.f;

  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    load_tile<HD, STR>(Ks, k + kv_off, k0, S, kv_stride, 1.f);
    load_tile<HD, STR>(Vs, v + kv_off, k0, S, kv_stride, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<HD, STR>(s, Qs, Ks, ty, tx);
    tile_dots<HD, STR>(dp, dOs, Vs, ty, tx);
    probs_and_grads(s, dp, lse_s, d_s, Ps, dSs, q0, k0, S, causal, window,
                    softcap, ty, tx);
    __syncthreads();
    acc_rows<HD, STR>(dq_acc, dSs, Ks, ty, tx);         // dQ += dS K
    __syncthreads();
  }
  store_rows<HD>(dq + q_off, dq_acc, q0, S, q_stride, scale, ty, tx);
}

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * 64 * (HD + 4) + 2 * 64 * PSTR + 2 * 64);
}

template <int HD, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dsum, void* dq, void* dk, void* dv, int B, int S,
                       int H, int KV, int causal, int window, float softcap,
                       cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  const int per_block = NTHREADS / 32;
  flash_bwd_dsum_kernel<HD, T><<<(unsigned)((rows + per_block - 1) / per_block),
                                 NTHREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = bwd_smem_bytes<HD>();
  const float scale = 1.0f / sqrtf((float)HD);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<HD, T><<<dim3((S + BK - 1) / BK, KV, B), NTHREADS,
                                 smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, causal, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD, T><<<dim3((S + BQ - 1) / BQ, H, B), NTHREADS, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), S, H, KV, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it).
// lse (B, H, S) f32 from the forward; dsum (B, H, S) f32 is scratch.
// Returns the first cudaError_t (0 = all three launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* dsum, void* dq, void* dk, void* dv,
                                   int B, int S, int H, int KV, int hd,
                                   int dtype, int causal, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_BWD(HD_, T_)                                                      \
  return (int)launch_bwd<HD_, T_>(q, k, v, o, dout, lse, dsum, dq, dk, dv,   \
                                  B, S, H, KV, causal, window, softcap, st)
  if (hd == 64 && dtype == 0) FA_BWD(64, float);
  if (hd == 64 && dtype == 1) FA_BWD(64, __nv_bfloat16);
  if (hd == 128 && dtype == 0) FA_BWD(128, float);
  if (hd == 128 && dtype == 1) FA_BWD(128, __nv_bfloat16);
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
