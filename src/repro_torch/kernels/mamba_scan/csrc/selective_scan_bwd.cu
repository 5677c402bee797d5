// Backward of the Mamba selective scan for Hopper (sm_90a), CUDA C++: the
// per-step reverse recurrence, one thread a channel, steps walked back one
// at a time from states re-run forward out of the forward's saved ones.
//
// No TPU counterpart: the reference has no VJP and jax.grad differentiates
// its plain forms.  With a_t = exp(dt_t A), h_{-1} = h0 and
//     h_t = a_t ⊙ h_{t-1} + (dt_t u_t) B_t,   y_t = h_t · C_t + D u_t,
// and g the gradient reaching h_t from later steps (at the last step the
// final state's gradient), step t back gives dh_t = g + C_t dy_t and
//     du_t  = Σ_n dh_t dt_t B_t + D dy_t,
//     ddt_t = Σ_n dh_t (A a_t h_{t-1} + u_t B_t),
//     dA   += dh_t dt_t a_t h_{t-1},   dD += dy_t u_t,
//     dB_t  = Σ_d dh_t dt_t u_t,       dC_t = Σ_d h_t dy_t,
// then g = a_t ⊙ dh_t; dh0 = g at the end.  u, dt, B, C, dy and du, ddt
// are float32 or bfloat16; A, D, the states and dA, dD, dh0 float32.  N is
// 4 or 16; any S >= 1 (the wrapper answers S = 0 itself) and d >= 1.
//
// States.  h_{t-1} is never rebuilt by dividing by a_t, which underflows.
// The forward (selective_scan.cu, `selective_scan_fwd_save`) writes h at
// every SAVE = 64-th step.  Per saved chunk, walking back: (1) the saved
// state run forward, the state at every L-th step written to a per-thread
// scratch in global memory (each entry written and read by the thread that
// owns it: no barrier); (2) per sub-chunk of L steps, last first, its L
// states re-run into registers, then its steps walked back.  The re-runs
// take the forward's decays (2^(dt A log2 e) on the SFU) and its update
// h = h a + (dt u) B in the same order, so they give the forward's states
// bit for bit.
//
// Sums over channels.  A CTA holds 64 channels of one batch row (2 warps).
// A step's 2N sums (dB_t, dC_t) are reduce-scattered over a warp's lanes,
// the two warps' partials added in warp order after the sub-chunk's
// barrier and written per channel block: (B, d/64, S, N) partials that the
// wrapper sums over blocks (one torch.sum).  dA and dD are written per
// batch row and summed over B by the wrapper.  No atomics, fixed orders:
// repeats are bit-identical.
//
// Bound on the card.  At jamba's shape (B=4, S=1024, d=8192, N=16, f32)
// it reads u, dt, dy and writes du, ddt (5 x 134.2 MB), reads the saved
// states (33.6 MB) and writes the dB, dC partials (2 x 33.6 MB; the
// scratch, L2-resident a pass, not counted): 0.78 GB, 0.23 ms at 3.35
// TB/s, the bound.  Per state entry and step about 28 f32 operations and
// three exps (the state re-run twice and the step back): 15.0 GFLOP, 0.22
// ms at 67 TFLOP/s, and 1.6 G exps at 16 a clock an SM, ~0.40 ms on the
// SFU at 1.98 GHz.  This first kernel walks the steps one at a time; the
// chunked form is the later design.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CPB = 64;              // channels of a CTA
constexpr int SAVE = 64;             // steps between the forward's states
constexpr float LOG2E = 1.4426950408889634f;

// The forward's exp: 2^x rounded by the SFU, 0 below -126 (.ftz).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                      // round to nearest even
}

template <typename T, int N>
__global__ void __launch_bounds__(CPB)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dp,
                const float* __restrict__ h_chunks, const T* __restrict__ dy,
                const float* __restrict__ dh_final, T* __restrict__ du,
                T* __restrict__ ddt, float* __restrict__ dA_part,
                float* __restrict__ dD_part, float* __restrict__ dB_part,
                float* __restrict__ dC_part, float* __restrict__ dh0,
                float* __restrict__ scratch, int S, int d) {
  constexpr int L = 64 / N;          // states kept in registers
  constexpr int NQ = SAVE / L;       // sub-chunks of a saved chunk
  constexpr int R = 2 * N;           // a step's sums over channels: dB, dC
  constexpr int KEPT = R >= 32 ? R / 32 : 1;
  constexpr int PLAIN = R >= 32 ? 0 : 32 / R - 1;   // lane bits summed plainly
  __shared__ float red[2][L][2][R];  // [buffer][step][warp][dB n | dC n]

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blk * CPB + tid;
  const bool valid = c < d;
  const int cc = min(c, d - 1);      // past d: channel d - 1, adding zeros
  const size_t row0 = (size_t)b * S;
  const int nsave = (S + SAVE - 1) / SAVE;
  float* scr = scratch + ((size_t)(b * nblk + blk) * NQ * N) * CPB;

  float a2[N], Af[N], g[N], dA[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    Af[e] = A[(size_t)cc * N + e];
    a2[e] = Af[e] * LOG2E;
    g[e] = valid && dh_final != nullptr
               ? dh_final[((size_t)b * d + cc) * N + e] : 0.f;
    dA[e] = 0.f;
  }
  const float Dc = Dp[cc];
  float dD = 0.f;
  int buf = 0;

  // One step forward from h: the forward's arithmetic.
  auto advance = [&](float (&h)[N], size_t row) {
    const float dtv = to_f32(dt[row * d + cc]);
    const float dtu = dtv * to_f32(u[row * d + cc]);
#pragma unroll
    for (int e = 0; e < N; ++e)
      h[e] = fmaf(h[e], ex2_approx(dtv * a2[e]),
                  dtu * to_f32(Bm[row * N + e]));
  };

  for (int n = nsave - 1; n >= 0; --n) {
    const int t0 = n * SAVE, steps = min(SAVE, S - t0);
    // (1) The saved state forward, every L-th step's to scratch.
    {
      float st[N];
      const float* hp = h_chunks + (((size_t)b * nsave + n) * d + cc) * N;
#pragma unroll
      for (int e = 0; e < N; ++e) st[e] = hp[e];
      for (int q = 0; q * L < steps; ++q) {
#pragma unroll
        for (int e = 0; e < N; ++e) scr[(q * N + e) * CPB + tid] = st[e];
        if ((q + 1) * L < steps) {
#pragma unroll
          for (int l = 0; l < L; ++l) advance(st, row0 + t0 + q * L + l);
        }
      }
    }
    // (2) Sub-chunks, last first.
    for (int q = (steps - 1) / L; q >= 0; --q) {
      float hl[L][N];
#pragma unroll
      for (int e = 0; e < N; ++e) hl[0][e] = scr[(q * N + e) * CPB + tid];
#pragma unroll
      for (int l = 1; l < L; ++l) {
#pragma unroll
        for (int e = 0; e < N; ++e) hl[l][e] = hl[l - 1][e];
        if (q * L + l - 1 < steps) advance(hl[l], row0 + t0 + q * L + l - 1);
      }
#pragma unroll
      for (int l = L - 1; l >= 0; --l) {
        const int t = q * L + l;
        if (t >= steps) continue;   // the same for every thread
        const size_t row = row0 + t0 + t;
        const float ut = to_f32(u[row * d + cc]);
        const float dtv = to_f32(dt[row * d + cc]);
        const float yt = valid ? to_f32(dy[row * d + cc]) : 0.f;
        const float dtu = dtv * ut;
        float vals[R], su = 0.f, sdt = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float Bn = to_f32(Bm[row * N + e]);
          const float Cn = to_f32(Cm[row * N + e]);
          const float a = ex2_approx(dtv * a2[e]);
          const float hp = hl[l][e];
          const float ht = fmaf(hp, a, dtu * Bn);
          const float dh = fmaf(Cn, yt, g[e]);
          vals[e] = dh * dtu;
          vals[N + e] = ht * yt;
          su = fmaf(dh, Bn, su);
          sdt = fmaf(dh, fmaf(Af[e] * a, hp, ut * Bn), sdt);
          dA[e] = fmaf(dh * dtv, a * hp, dA[e]);
          g[e] = a * dh;
        }
        dD = fmaf(yt, ut, dD);
        if (valid) {
          put(du + row * d + c, fmaf(su, dtv, Dc * yt));
          put(ddt + row * d + c, sdt);
        }
        // dB_t, dC_t over the warp's 32 channels: reduce-scatter while
        // values remain to split, plain sums after.
        int off = 0;
#pragma unroll
        for (int lvl = 0; lvl < 5; ++lvl) {
          const int o = 16 >> lvl, m = R >> lvl;
          if (m >= 2) {
            const bool up = lane & o;
#pragma unroll
            for (int j = 0; j < m / 2; ++j) {
              const float lo = vals[j], hi = vals[j + m / 2];
              const float send = up ? lo : hi, keep = up ? hi : lo;
              vals[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
            if (up) off += m / 2;
          } else {
            vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], o);
          }
        }
        if ((lane & PLAIN) == 0) {
#pragma unroll
          for (int m = 0; m < KEPT; ++m) red[buf][l][warp][off + m] = vals[m];
        }
      }
      __syncthreads();
      // The sub-chunk's dB, dC partials of this channel block.
      for (int it = tid; it < L * R; it += CPB) {
        const int l = it / R, j = it % R, t = q * L + l;
        if (t >= steps) continue;
        const float x = red[buf][l][0][j] + red[buf][l][1][j];
        float* dst = j < N ? dB_part : dC_part;
        dst[(((size_t)b * nblk + blk) * S + t0 + t) * N + j % N] = x;
      }
      buf ^= 1;
    }
  }
  if (valid) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      dh0[((size_t)b * d + c) * N + e] = g[e];
      dA_part[((size_t)b * d + c) * N + e] = dA[e];
    }
    dD_part[(size_t)b * d + c] = dD;
  }
}

template <typename T, int N>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* Dp,
                   const void* h_chunks, const void* dy, const void* dh_final,
                   void* du, void* ddt, void* dA_part, void* dD_part,
                   void* dB_part, void* dC_part, void* dh0, void* scratch,
                   int B, int S, int d, cudaStream_t st) {
  const dim3 grid((d + CPB - 1) / CPB, B);
  scan_bwd_kernel<T, N><<<grid, CPB, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(h_chunks), static_cast<const T*>(dy),
      static_cast<const float*>(dh_final), static_cast<T*>(du),
      static_cast<T*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dh0),
      static_cast<float*>(scratch), S, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const void* u, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* Dp,
                       const void* h_chunks, const void* dy,
                       const void* dh_final, void* du, void* ddt,
                       void* dA_part, void* dD_part, void* dB_part,
                       void* dC_part, void* dh0, void* scratch, int B, int S,
                       int d, cudaStream_t st) {
  switch (N) {
#define SCAN_BWD_CASE(K)                                                    \
  case K:                                                                   \
    return launch<T, K>(u, dt, A, Bm, Cm, Dp, h_chunks, dy, dh_final, du,  \
                        ddt, dA_part, dD_part, dB_part, dC_part, dh0,      \
                        scratch, B, S, d, st);
    SCAN_BWD_CASE(4)
    SCAN_BWD_CASE(16)
#undef SCAN_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the backward needs per channel (0 if it does not take
// N): the states of a saved chunk's sub-chunk starts.
extern "C" int selective_scan_bwd_scratch_floats(int N) {
  return N == 4 || N == 16 ? SAVE / (64 / N) * N : 0;
}

// u, dt, dy, du, ddt: (B,S,d) contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); Bm, Cm: (B,S,N) of that dtype; A: (d,N), Dp: (d,) float32;
// h_chunks: (B,ceil(S/64),d,N) float32 from selective_scan_fwd_save;
// dh_final (nullable), dh0: (B,d,N) float32; dA_part: (B,d,N), dD_part:
// (B,d) float32 (the caller sums over B); dB_part, dC_part:
// (B,ceil(d/64),S,N) float32 (the caller sums over the channel blocks);
// scratch: B*ceil(d/64)*64*selective_scan_bwd_scratch_floats(N) float32.
// Launches on `stream`; returns the launch's CUDA error code (0 on success).
extern "C" int selective_scan_bwd(const void* u, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* Dp,
                                  const void* h_chunks, const void* dy,
                                  const void* dh_final, void* du, void* ddt,
                                  void* dA_part, void* dD_part, void* dB_part,
                                  void* dC_part, void* dh0, void* scratch,
                                  int B, int S, int d, int N, int dtype,
                                  void* stream) {
  if (B <= 0 || B > 65535 || d <= 0 || S <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch_n<float>(N, u, dt, A, Bm, Cm, Dp, h_chunks, dy, dh_final,
                              du, ddt, dA_part, dD_part, dB_part, dC_part,
                              dh0, scratch, B, S, d, st)
          : dispatch_n<__nv_bfloat16>(N, u, dt, A, Bm, Cm, Dp, h_chunks, dy,
                                      dh_final, du, ddt, dA_part, dD_part,
                                      dB_part, dC_part, dh0, scratch, B, S, d,
                                      st);
  return (int)err;
}
