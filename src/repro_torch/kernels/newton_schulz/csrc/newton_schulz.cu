// Newton–Schulz orthogonalization (Muon) for Hopper (sm_90a), CUDA C++ with
// plain f32 FMA.
//
// Replaces two Pallas kernels of src/repro/kernels/newton_schulz/kernel.py:
//
//   * ns_fused (the whole matrix resident in VMEM, all quintic iterations in
//     one kernel).  Whole-matrix residency does not carry over: a GPT-2 MLP
//     matrix (768x3072 f32) is 9.4 MiB against at most 227 KB of shared
//     memory per block.  Its counterpart here is a chain, batched over the
//     leading layer-stack axis so that every layer of a stacked leaf goes
//     through one launch per stage:
//       1. sumsq_partial + scale_by_norm: X = x / (||x||_F + eps) per matrix,
//          a deterministic two-pass reduction (fixed chunks, fixed tree, no
//          atomics);
//       2. per iteration, three launches of one batched GEMM with a fused
//          epilogue  out = alpha * A * op(B) + beta * D:
//            G = X * X^T        (B read transposed, never materialized)
//            P = c * G * G + b * G
//            X' = P * X + a * X (ping-pong buffers: X is read while X' is
//                                written)
//   * matmul (the tiled (M,K)@(K,N) with an f32 accumulator that the
//     reference composes for matrices too large to fuse): the same GEMM's
//     unbatched entry point, alpha = 1, beta = 0, with a flag for a
//     transposed right operand so x @ x.T never materializes x.T.
//
// Precision: inputs f32 or bf16, widened to f32 on load; every product and
// sum is f32 FMA (no tensor cores, no TF32); the output is rounded once to
// its type.
//
// GEMM design.  128x128 output tiles, 8-deep k-slices, 256 threads; each
// thread owns an 8x8 register micro-tile (rows 4ty..4ty+3 and +64, columns
// 4tx..4tx+3 and +64, so every shared-memory read is a conflict-free
// float4).  A and B slices are staged through registers into a double
// buffer in shared memory (the next slice's global loads are in flight
// while the current one is multiplied; one barrier per slice).  The A slice
// is stored k-major with a 4-float pad so its transposing store does not
// conflict.  Ragged M, N and K are masked on load and on store; nothing
// relies on the caller padding to the TPU's 128.  The batch index is
// blockIdx.z with per-operand batch strides.
//
// Bound on the card (H100 SXM, 67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s): one quintic iteration on an n x m matrix (n <= m) costs
// 4n^2 m + 2n^3 FLOP against ~3 n m + 3 n^2 floats moved, so at the GPT-2
// shapes (n = 768) every launch is bound by f32 operations by a factor of
// ~100; a 12-layer 768x3072 leaf is 0.49 TFLOP per 5-step call, 7.3 ms at
// the f32 peak.  The design keeps operands in registers and shared memory
// and reads each element of A and B once per 128-wide output tile.
//
// What the simple design leaves on the table: tensor cores (TF32 or bf16
// wgmma, ~7-15x the f32 rate, with an accuracy argument for NS), TMA loads
// into a deeper ring with warp specialisation, a symmetric Gram that
// computes half the tiles of X X^T and G G, and split-K for the tied
// embedding's 768x50304 Gram (36 output tiles leave most of the 132 SMs
// idle in that launch).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int GEMM_THREADS = 256;
constexpr int PAD = 4;             // k-major A/B^T stores stay conflict-free

constexpr int NORM_THREADS = 256;
constexpr int NORM_PARTS = 32;     // fixed chunks per matrix: deterministic

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// C[z] = alpha * A[z] * op(B[z]) + beta * D[z]  (D may be null).
// A (M,K) row stride lda; op(B) is (K,N): B (K,N) with row stride ldb, or
// with TRANS_B, B stored (N,K) with row stride ldb.  D, C (M,N).
template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ D, T* __restrict__ C, int M, int N, int K,
            long long lda, long long ldb, long long ldd, long long ldc,
            long long sa, long long sb, long long sd, long long sc,
            float alpha, float beta) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const long long z = blockIdx.z;
  A += z * sa;
  B += z * sb;
  C += z * sc;
  if (D != nullptr) D += z * sd;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // Load mapping of one k-slice: A rows (and B^T rows) take two threads of
  // four consecutive k each; B (K,N) rows take 32 threads of four
  // consecutive n each.
  const int r_row = tid >> 1;          // 0..127
  const int r_k = (tid & 1) * 4;       // 0 or 4
  const int b_k = tid >> 5;            // 0..7
  const int b_n = (tid & 31) * 4;      // 0..124
  float ra[4], rb[4];

  auto load = [&](int k0) {
    const int ar = m0 + r_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + r_k + i;
      ra[i] = (ar < M && k < K) ? to_f32(A[(long long)ar * lda + k]) : 0.f;
    }
    if (TRANS_B) {
      const int bn = n0 + r_row;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + r_k + i;
        rb[i] = (bn < N && k < K) ? to_f32(B[(long long)bn * ldb + k]) : 0.f;
      }
    } else {
      const int k = k0 + b_k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int bn = n0 + b_n + i;
        rb[i] = (bn < N && k < K) ? to_f32(B[(long long)k * ldb + bn]) : 0.f;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][r_k + i][r_row] = ra[i];
    if (TRANS_B) {
#pragma unroll
      for (int i = 0; i < 4; ++i) Bs[buf][r_k + i][r_row] = rb[i];
    } else {
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);      // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // Nobody reads buf ^ 1 in this iteration (its readers passed the
    // barrier at the end of the previous one), so it can be filled now.
    if (t + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + 4 * ty + (i & 3) + (i >> 2) * 64;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 4 * tx + (j & 3) + (j >> 2) * 64;
      if (c >= N) continue;
      float val = alpha * acc[i][j];
      if (D != nullptr) val = fmaf(beta, to_f32(D[(long long)r * ldd + c]), val);
      store_f32(&C[(long long)r * ldc + c], val);
    }
  }
}

// Block-wide sum in a fixed order (shuffle tree, then warp 0 over the warp
// sums): the same inputs give the same bits on every run.
__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

// partial[z * NORM_PARTS + p] = sum of squares of chunk p of matrix z.
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
sumsq_partial(const T* __restrict__ x, long long per, float* __restrict__ partial) {
  __shared__ float red[NORM_THREADS / 32];
  const long long chunk = (per + NORM_PARTS - 1) / NORM_PARTS;
  const long long beg = blockIdx.x * chunk;
  const long long end = min(per, beg + chunk);
  const T* base = x + (long long)blockIdx.y * per;
  float s = 0.f;
  for (long long i = beg + threadIdx.x; i < end; i += NORM_THREADS) {
    const float v = to_f32(base[i]);
    s = fmaf(v, v, s);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.y * NORM_PARTS + blockIdx.x] = s;
}

// y[z] = x[z] / (sqrt(sum of partials of z) + eps), widened to f32.
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
scale_by_norm(const T* __restrict__ x, float* __restrict__ y, long long per,
              const float* __restrict__ partial, float eps) {
  __shared__ float norm;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int p = 0; p < NORM_PARTS; ++p) s += partial[blockIdx.y * NORM_PARTS + p];
    norm = sqrtf(s) + eps;
  }
  __syncthreads();
  const float nv = norm;
  const long long off = (long long)blockIdx.y * per;
  for (long long i = (long long)blockIdx.x * NORM_THREADS + threadIdx.x; i < per;
       i += (long long)gridDim.x * NORM_THREADS)
    y[off + i] = to_f32(x[off + i]) / nv;
}

template <typename T, bool TRANS_B>
cudaError_t gemm(const void* a, const void* b, const void* d, void* c,
                 int batch, int M, int N, int K, long long lda, long long ldb,
                 long long ldd, long long ldc, long long sa, long long sb,
                 long long sd, long long sc, float alpha, float beta,
                 cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<T, TRANS_B><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(d), static_cast<T*>(c), M, N, K, lda, ldb, ldd,
      ldc, sa, sb, sd, sc, alpha, beta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t normalize(const void* x, float* y, float* partial, int L,
                      long long per, float eps, cudaStream_t stream) {
  sumsq_partial<T><<<dim3(NORM_PARTS, L), NORM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), per, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long want = (per + NORM_THREADS - 1) / NORM_THREADS;
  const int blocks = (int)(want < 256 ? want : 256);
  scale_by_norm<T><<<dim3(blocks, L), NORM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), y, per, partial, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B, D and C share it).
// Returns a cudaError_t (0 = launched).
extern "C" int ns_gemm(const void* a, const void* b, const void* d, void* c,
                       int batch, int M, int N, int K, long long lda,
                       long long ldb, long long ldd, long long ldc,
                       long long sa, long long sb, long long sd, long long sc,
                       int trans_b, float alpha, float beta, int dtype,
                       void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || batch > 65535 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && trans_b)
    return (int)gemm<float, true>(a, b, d, c, batch, M, N, K, lda, ldb, ldd, ldc, sa, sb, sd, sc, alpha, beta, st);
  if (dtype == 0)
    return (int)gemm<float, false>(a, b, d, c, batch, M, N, K, lda, ldb, ldd, ldc, sa, sb, sd, sc, alpha, beta, st);
  if (dtype == 1 && trans_b)
    return (int)gemm<__nv_bfloat16, true>(a, b, d, c, batch, M, N, K, lda, ldb, ldd, ldc, sa, sb, sd, sc, alpha, beta, st);
  if (dtype == 1)
    return (int)gemm<__nv_bfloat16, false>(a, b, d, c, batch, M, N, K, lda, ldb, ldd, ldc, sa, sb, sd, sc, alpha, beta, st);
  return (int)cudaErrorInvalidValue;
}

// The whole Newton–Schulz chain on x (L, n, m), n <= m, of type dtype:
// xa, xb (L, n, m) and g, p (L, n, n) are f32 work buffers, partial holds
// L * 32 floats.  After `steps` iterations the result is in xa when steps
// is even and in xb when it is odd.  (ca, cb, cc) are the quintic's
// coefficients.  Returns the first cudaError_t (0 = all launched).
extern "C" int ns_fused(const void* x, float* xa, float* xb, float* g,
                        float* p, float* partial, int L, int n, int m,
                        int steps, float eps, float ca, float cb, float cc,
                        int dtype, void* stream) {
  if (L <= 0 || L > 65535 || n <= 0 || m <= 0 || n > m || steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per = (long long)n * m;
  const long long nn = (long long)n * n;
  cudaError_t err;
  if (dtype == 0) err = normalize<float>(x, xa, partial, L, per, eps, st);
  else if (dtype == 1) err = normalize<__nv_bfloat16>(x, xa, partial, L, per, eps, st);
  else return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  float* cur = xa;
  float* nxt = xb;
  for (int s = 0; s < steps; ++s) {
    // G = X X^T
    err = gemm<float, true>(cur, cur, nullptr, g, L, n, n, m, m, m, 0, n,
                            per, per, 0, nn, 1.f, 0.f, st);
    if (err != cudaSuccess) return (int)err;
    // P = c G G + b G
    err = gemm<float, false>(g, g, g, p, L, n, n, n, n, n, n, n, nn, nn, nn,
                             nn, cc, cb, st);
    if (err != cudaSuccess) return (int)err;
    // X' = P X + a X
    err = gemm<float, false>(p, cur, cur, nxt, L, n, m, n, n, m, m, m, nn,
                             per, per, per, 1.f, ca, st);
    if (err != cudaSuccess) return (int)err;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}
