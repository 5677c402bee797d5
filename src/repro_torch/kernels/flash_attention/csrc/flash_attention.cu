// Flash attention forward for Hopper (sm_90a), CUDA C++ with plain f32 FMA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_tpu
// (the Pallas body `_body`).  Same function: q (B,S,H,hd), k/v (B,S,KV,hd)
// -> o (B,S,H,hd); scores q·k/sqrt(hd) (q pre-scaled, as the Pallas body
// does), optional softcap·tanh(s/softcap), causal (qi >= ki) and window
// (qi - ki < window) masks with NEG_INF = -1e30, online softmax with the
// running max m, sum l and accumulator in f32, l clamped to 1e-30 at the
// end.  GQA: q head h reads kv head h / (H/KV); K/V are never repeated.
// Key tiles that the masks cover entirely are never visited.  Training
// passes an lse pointer and gets each row's logsumexp m + log(l) as
// (B, H, S) f32, which the backward (flash_attention_bwd.cu) recomputes
// the probabilities from; the serving paths pass null and run the same
// arithmetic.
//
// Precision: inputs f32 or bf16, converted to f32 on load; every product,
// sum and exp is f32 (no tensor cores, no TF32); the output is rounded once
// to the input type (round to nearest even for bf16).
//
// Design.  Grid (ceil(S/BQ), H, B); one CTA of 256 threads owns BQ = 64
// query rows of one head and loops over the k-tiles between its window and
// causal limits.  Q (pre-scaled), the K and V tiles and the probability
// tile P live in shared memory as f32.  The 16x16 thread grid computes the
// 64x64 score tile as 4x4 register micro-tiles (thread (ty, tx) owns rows
// ty + 16i and keys tx + 16j), reading Q and K four dims at a time as
// float4; the row max and sum of the online softmax are reduced across the
// 16 lanes of a half-warp that share a row.  The same thread then owns the
// output rows ty + 16i at columns 4tx..4tx+3 (+64), so its running m/l
// rescale its own accumulator with no exchange.  The ragged last query and
// key tiles are masked, never padded by the caller; heavy (late) query
// tiles of a causal launch are issued first.
//
// Bound on the card: at the serving prefill shape (B=8, S=512, H=12,
// hd=64, causal, f32) the work is 4·B·H·hd·S(S+1)/2 ≈ 3.2 GFLOP, ≈ 48 us at
// the H100 SXM's 67 TFLOP/s f32 outside the tensor cores, against ≈ 50 MB of
// q/k/v/o, ≈ 15 us at 3.35 TB/s: this kernel is bound by f32 operations.
//
// What the simple design leaves on the table: tensor cores (wgmma on bf16
// or TF32 inputs would lift the operation bound ~15x), TMA loads and a
// double-buffered K/V ring (here each tile load is waited for with the SMs
// idle), warp specialisation, and a persistent schedule across tiles.

#include "flash_common.cuh"

namespace {

template <int HD, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse,
                 int S, int H, int KV, int causal, int window, float softcap,
                 float scale) {
  constexpr int QSTR = HD + 4;   // float4 rows, conflict-free column reads
  constexpr int KSTR = HD + 4;
  constexpr int VSTR = HD;
  constexpr int PSTR = BK + 4;
  constexpr int NC = HD / 64;    // float4 column groups per thread in P·V

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [BQ][QSTR]
  float* Ks = Qs + BQ * QSTR;            // [BK][KSTR]
  float* Vs = Ks + BK * KSTR;            // [BK][VSTR]
  float* Ps = Vs + BK * VSTR;            // [BQ][PSTR]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // Causal work grows with the query tile: issue the late tiles first.
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;

  const int q_stride = H * HD;
  const int kv_stride = KV * HD;
  const T* qbase = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const T* kbase = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const T* vbase = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  T* obase = o + (size_t)b * S * q_stride + (size_t)h * HD;

  load_tile<HD, QSTR>(Qs, qbase, q0, S, q_stride, scale);

  // Key range this query tile can see.
  int k_hi = S - 1;
  if (causal) k_hi = min(k_hi, q0 + BQ - 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_begin = k_lo / BK;
  const int kt_end = k_hi / BK;          // inclusive

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    load_tile<HD, KSTR>(Ks, kbase, k0, S, kv_stride, 1.f);
    load_tile<HD, VSTR>(Vs, vbase, k0, S, kv_stride, 1.f);
    __syncthreads();

    // Scores: s[i][j] = Qs[ty + 16i] · Ks[tx + 16j].
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QSTR + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KSTR + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv4[j].x, a);
          a = fmaf(qv[i].y, kv4[j].y, a);
          a = fmaf(qv[i].z, kv4[j].z, a);
          a = fmaf(qv[i].w, kv4[j].w, a);
          s[i][j] = a;
        }
    }

    // Softcap, masks and the online-softmax update, row by row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = ki < S;
        if (causal) ok = ok && (qi >= ki);
        if (window > 0) ok = ok && (qi - ki < window);
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[i][4g + e] += sum_kk P[ty + 16i][kk] * V[kk][64g + 4tx + e].
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PSTR + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (kk + e) * VSTR + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 out = make_float4(acc[i][4 * g + 0] * inv, acc[i][4 * g + 1] * inv,
                                     acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
      store4(obase + (size_t)qi * q_stride + 64 * g + 4 * tx, out);
    }
    // The 16 lanes of a row hold the same m and l after the reductions.
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * (BK + 4));
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  // Above 48 KB a kernel must opt in to dynamic shared memory; the call is
  // cheap, and a per-process flag would have to be thread-safe.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_fwd_kernel<HD, T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KV, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse (B, H, S) f32 receives each row's
// logsumexp of its (scaled, softcapped, masked) scores for the backward, or
// is null (the serving paths).  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int S, int H,
                                   int KV, int hd, int dtype, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64 && dtype == 0)
    return (int)launch<64, float>(q, k, v, o, lse, B, S, H, KV, causal, window, softcap, st);
  if (hd == 64 && dtype == 1)
    return (int)launch<64, __nv_bfloat16>(q, k, v, o, lse, B, S, H, KV, causal, window, softcap, st);
  if (hd == 128 && dtype == 0)
    return (int)launch<128, float>(q, k, v, o, lse, B, S, H, KV, causal, window, softcap, st);
  if (hd == 128 && dtype == 1)
    return (int)launch<128, __nv_bfloat16>(q, k, v, o, lse, B, S, H, KV, causal, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
