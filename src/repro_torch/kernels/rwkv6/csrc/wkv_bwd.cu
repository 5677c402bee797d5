// Backward of the RWKV6 WKV recurrence for Hopper (sm_90a), CUDA C++: the
// per-step reverse recurrence, one CTA per (b, h), steps walked back one at
// a time from states re-run forward out of the forward's chunk starts.
//
// No TPU counterpart: the reference has no VJP and jax.grad differentiates
// its plain forms.  With P_t the state before step t (P_0 = S_0),
//     y_t = r_t · (P_t + diag(u) k_t v_t^T),  P_{t+1} = diag(w_t) P_t + k_t v_t^T,
// and G_t = dL/dP_t (G_S = the final state's gradient), step t back gives
//     G_t   = diag(w_t) G_{t+1} + r_t dy_t^T,
//     dr_t  = P_t dy_t + (u ⊙ k_t) (v_t · dy_t),
//     dk_t  = G_{t+1} v_t + (r_t ⊙ u) (v_t · dy_t),
//     dv_t  = G_{t+1}^T k_t + (r_t · (u ⊙ k_t)) dy_t,
//     dw_t  = Σ_j G_{t+1}[:, j] ⊙ P_t[:, j],
//     du   += r_t ⊙ k_t (v_t · dy_t),
// and dS_0 = G_0.  r, k, v, dy and dr, dk, dv are float32 or bfloat16; w,
// u, the states and dw, du, dS_0 float32.  hd 16, 32, 64 or 128, any S >= 1
// (the wrapper answers S = 0 itself).
//
// States.  P_t is never rebuilt as (P_{t+1} - k_t v_t^T) / w_t: the model's
// w = exp(-exp(x)) reaches 0.  The forward (wkv.cu, `wkv_fwd_save`) writes
// P at each chunk start (every C steps, the forward's chunk).  Per chunk,
// walking back: (1) the chunk's r, k, v, w, dy to shared memory as f32,
// and per step the scalars v_t · dy_t and r_t · (u ⊙ k_t); (2) the chunk
// start's state run forward step by step, the state at every L-th step
// written to a per-CTA scratch (global memory, each entry written and read
// by the thread that owns it: no barrier); (3) per sub-chunk of L steps,
// last first, its L states re-run from the scratch into registers, then
// its steps walked back.
//
// Layout.  NT = 4 hd threads; thread (i, cg) owns row i of the state and
// the E = hd / 4 columns j = cg + 4 e, its entries of P and G in registers.
// A step's row sums (dr, dk and dw over j) are within a thread and then
// over the 4 consecutive lanes of a row (two shuffles); dv's column sums
// over i are reduce-scattered over the warp's 8 rows (lanes 4 apart) and
// the warps' partials summed through shared memory, in warp order, after
// the sub-chunk's barrier, where every output of the sub-chunk is formed
// and stored.  du sums over time in a fixed thread per channel and is
// written per (b, h); the wrapper sums over b.  No atomics, a fixed order
// of sums: repeats are bit-identical.
//
// Bound on the card.  At the serving shape (B=4, S=1024, H=64, hd=64, f32)
// it reads r, k, v, w, dy and writes dr, dk, dv, dw (9 x 67.1 MB), reads
// the chunk states (134.2 MB) and reads and writes the scratch (33.6 MB of
// L2-resident states a pass, not counted): 0.75 GB, 0.22 ms at 3.35 TB/s;
// per state entry and step 17 f32 operations (the state re-run twice at 3
// each, dr, dk and dw as FMAs, dv's multiply and sum, G's multiply and
// FMA): 18.3 GFLOP, 0.27 ms at 67 TFLOP/s, the bound.  This first kernel
// takes every product on the CUDA cores, step by step; the chunked
// tensor-core form of the forward is the later design.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CG = 4;            // lanes of a state row

template <int HD> struct BCfg {
  static constexpr int C = HD >= 128 ? 16 : 32;  // the forward's chunk
  static constexpr int NT = HD * CG;
  static constexpr int NW = NT / 32;
  static constexpr int E = HD / CG;              // columns of a thread
  static constexpr int L = E <= 16 ? 64 / E : 1; // states kept in registers
  static constexpr int NQ = C / L;               // sub-chunks of a chunk
  // Shared memory, in floats: the chunk's five streams, u, the per-step
  // scalars, and double-buffered row sums and dv partials.
  static constexpr int OFF_U = 5 * C * HD;
  static constexpr int OFF_VDY = OFF_U + HD;
  static constexpr int OFF_RKU = OFF_VDY + C;
  static constexpr int OFF_ROW = OFF_RKU + C;
  static constexpr int ROW = L * 3 * HD;
  static constexpr int OFF_DV = OFF_ROW + 2 * ROW;
  static constexpr int DV = L * NW * HD;
  static constexpr int SMEM = (OFF_DV + 2 * DV) * 4;
  static_assert(C % L == 0, "sub-chunks tile a chunk");
  static_assert(E == 4 || E % 8 == 0, "dv's reduce-scatter");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                      // round to nearest even
}

template <typename T, int HD>
__global__ void __launch_bounds__(BCfg<HD>::NT)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u,
               const float* __restrict__ s_chunks, const T* __restrict__ dy,
               const float* __restrict__ ds_final, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, float* __restrict__ scratch, int S,
               int H) {
  using P = BCfg<HD>;
  constexpr int C = P::C, NT = P::NT, NW = P::NW, E = P::E, L = P::L;
  constexpr int NQ = P::NQ;
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                 // [C][HD] each, f32
  float* ks = rs + C * HD;
  float* vs = ks + C * HD;
  float* ws = vs + C * HD;
  float* ys = ws + C * HD;        // dy
  float* us = sm + P::OFF_U;
  float* vdy = sm + P::OFF_VDY;   // v_t · dy_t
  float* rku = sm + P::OFF_RKU;   // r_t · (u ⊙ k_t)
  float* rowb = sm + P::OFF_ROW;  // [2][L][3][HD]: dr, dk, dw row sums
  float* dvp = sm + P::OFF_DV;    // [2][L][NW][HD]: dv partials per warp

  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = tid / CG, cg = tid % CG;
  const size_t row_step = (size_t)H * HD;
  const size_t base = ((size_t)b * S * H + h) * HD;
  const int nchunks = (S + C - 1) / C;
  float* scr = scratch + (size_t)bh * NQ * E * NT;   // [NQ][E][NT]

  for (int c = tid; c < HD; c += NT) us[c] = u[(size_t)h * HD + c];
  float G[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    G[e] = ds_final != nullptr
               ? ds_final[((size_t)bh * HD + i) * HD + cg + CG * e] : 0.f;
  float du_acc = 0.f;              // channel tid's du, tid < HD
  int buf = 0;

  for (int n = nchunks - 1; n >= 0; --n) {
    const int t0 = n * C, steps = min(C, S - t0);
    // (1) The chunk's streams as f32, zeros past S.
    __syncthreads();
    for (int q = tid; q < C * HD; q += NT) {
      const int t = q / HD, c = q % HD;
      const bool in = t < steps;
      const size_t g = base + (size_t)(t0 + t) * row_step + c;
      rs[q] = in ? to_f32(r[g]) : 0.f;
      ks[q] = in ? to_f32(k[g]) : 0.f;
      vs[q] = in ? to_f32(v[g]) : 0.f;
      ws[q] = in ? w[g] : 0.f;
      ys[q] = in ? to_f32(dy[g]) : 0.f;
    }
    __syncthreads();
    // The per-step scalars, a warp a step, lanes over channels.
    for (int t = warp; t < C; t += NW) {
      float a = 0.f, c2 = 0.f;
      for (int c = lane; c < HD; c += 32) {
        a = fmaf(vs[t * HD + c], ys[t * HD + c], a);
        c2 = fmaf(rs[t * HD + c] * us[c], ks[t * HD + c], c2);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        c2 += __shfl_xor_sync(0xffffffffu, c2, o);
      }
      if (lane == 0) { vdy[t] = a; rku[t] = c2; }
    }
    // (2) The chunk start's state forward, every L-th step's to scratch.
    {
      float st[E];
      const float* cp = s_chunks + (((size_t)bh * nchunks + n) * HD + i) * HD;
#pragma unroll
      for (int e = 0; e < E; ++e) st[e] = cp[cg + CG * e];
      for (int q = 0; q < NQ && q * L < steps; ++q) {
#pragma unroll
        for (int e = 0; e < E; ++e) scr[(q * E + e) * NT + tid] = st[e];
        if (q + 1 < NQ) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const int t = q * L + l;
            const float wi = ws[t * HD + i], ki = ks[t * HD + i];
#pragma unroll
            for (int e = 0; e < E; ++e)
              st[e] = fmaf(st[e], wi, ki * vs[t * HD + cg + CG * e]);
          }
        }
      }
    }
    __syncthreads();               // the per-step scalars
    // (3) Sub-chunks, last first.
    for (int q = (steps - 1) / L; q >= 0; --q) {
      float Pl[L][E];
#pragma unroll
      for (int e = 0; e < E; ++e) Pl[0][e] = scr[(q * E + e) * NT + tid];
#pragma unroll
      for (int l = 1; l < L; ++l) {
        const int t = q * L + l - 1;
        const float wi = ws[t * HD + i], ki = ks[t * HD + i];
#pragma unroll
        for (int e = 0; e < E; ++e)
          Pl[l][e] = fmaf(Pl[l - 1][e], wi, ki * vs[t * HD + cg + CG * e]);
      }
      float* rb = rowb + buf * P::ROW;
      float* dp = dvp + buf * P::DV;
#pragma unroll
      for (int l = L - 1; l >= 0; --l) {
        const int t = q * L + l;
        if (t >= steps) continue;  // the same for every thread
        const float ri = rs[t * HD + i], ki = ks[t * HD + i];
        const float wi = ws[t * HD + i];
        float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f, cv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int j = cg + CG * e;
          const float vj = vs[t * HD + j], yj = ys[t * HD + j];
          a_dr = fmaf(Pl[l][e], yj, a_dr);
          a_dw = fmaf(G[e], Pl[l][e], a_dw);
          a_dk = fmaf(G[e], vj, a_dk);
          cv[e] = G[e] * ki;
          G[e] = fmaf(G[e], wi, ri * yj);
        }
#pragma unroll
        for (int o = 1; o < CG; o <<= 1) {
          a_dr += __shfl_xor_sync(0xffffffffu, a_dr, o);
          a_dk += __shfl_xor_sync(0xffffffffu, a_dk, o);
          a_dw += __shfl_xor_sync(0xffffffffu, a_dw, o);
        }
        // dv over the warp's 8 rows (lane bits 2-4): reduce-scatter while
        // values remain to split, plain sums after.
        int off = 0;
#pragma unroll
        for (int lvl = 0; lvl < 3; ++lvl) {
          const int o = 16 >> lvl, m = E >> lvl;
          if (m >= 2) {
            const bool up = lane & o;
#pragma unroll
            for (int j = 0; j < m / 2; ++j) {
              const float lo = cv[j], hi = cv[j + m / 2];
              const float send = up ? lo : hi, keep = up ? hi : lo;
              cv[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
            if (up) off += m / 2;
          } else {
            cv[0] += __shfl_xor_sync(0xffffffffu, cv[0], o);
          }
        }
        if (cg < 3) rb[(l * 3 + cg) * HD + i] = cg == 0 ? a_dr
                                                : cg == 1 ? a_dk : a_dw;
        constexpr int KEPT = E >= 8 ? E / 8 : 1;
        constexpr int PLAIN = E >= 8 ? 0 : 4;  // lane bits summed plainly
        if ((lane & PLAIN) == 0) {
#pragma unroll
          for (int m = 0; m < KEPT; ++m)
            dp[(l * NW + warp) * HD + cg + CG * (off + m)] = cv[m];
        }
      }
      __syncthreads();
      // The sub-chunk's outputs: rows t, channels c.
      for (int it = tid; it < L * HD; it += NT) {
        const int l = it / HD, c = it % HD, t = q * L + l;
        if (t >= steps) continue;
        const float vd = vdy[t];
        const float x_dr = rb[(l * 3) * HD + c] + us[c] * ks[t * HD + c] * vd;
        const float x_dk = rb[(l * 3 + 1) * HD + c]
                           + rs[t * HD + c] * us[c] * vd;
        float x_dv = 0.f;
#pragma unroll
        for (int ww = 0; ww < NW; ++ww) x_dv += dp[(l * NW + ww) * HD + c];
        x_dv = fmaf(rku[t], ys[t * HD + c], x_dv);
        const size_t g = base + (size_t)(t0 + t) * row_step + c;
        put(dr + g, x_dr);
        put(dk + g, x_dk);
        put(dv + g, x_dv);
        dw[g] = rb[(l * 3 + 2) * HD + c];
      }
      if (tid < HD) {
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
          const int t = q * L + l;
          if (t < steps)
            du_acc = fmaf(rs[t * HD + tid] * ks[t * HD + tid], vdy[t],
                          du_acc);
        }
      }
      buf ^= 1;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    ds0[((size_t)bh * HD + i) * HD + cg + CG * e] = G[e];
  if (tid < HD) du_part[(size_t)bh * HD + tid] = du_acc;
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s_chunks, const void* dy,
                   const void* ds_final, void* dr, void* dk, void* dv,
                   void* dw, void* du_part, void* ds0, void* scratch, int B,
                   int S, int H, cudaStream_t st) {
  using P = BCfg<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<T, HD><<<B * H, P::NT, P::SMEM, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s_chunks),
      static_cast<const T*>(dy), static_cast<const float*>(ds_final),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part),
      static_cast<float*>(ds0), static_cast<float*>(scratch), S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s_chunks,
                        const void* dy, const void* ds_final, void* dr,
                        void* dk, void* dv, void* dw, void* du_part, void* ds0,
                        void* scratch, int B, int S, int H, cudaStream_t st) {
  switch (hd) {
#define WKV_BWD_CASE(D)                                                     \
  case D:                                                                   \
    return launch<T, D>(r, k, v, w, u, s_chunks, dy, ds_final, dr, dk, dv, \
                        dw, du_part, ds0, scratch, B, S, H, st);
    WKV_BWD_CASE(16)
    WKV_BWD_CASE(32)
    WKV_BWD_CASE(64)
    WKV_BWD_CASE(128)
#undef WKV_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the backward needs per (b, h) at head dim hd (0 if it
// does not take hd): the states of a chunk's sub-chunk starts.
extern "C" int wkv_bwd_scratch_floats(int hd) {
  switch (hd) {
    case 16: return BCfg<16>::NQ * 16 * 16;
    case 32: return BCfg<32>::NQ * 32 * 32;
    case 64: return BCfg<64>::NQ * 64 * 64;
    case 128: return BCfg<128>::NQ * 128 * 128;
    default: return 0;
  }
}

// r, k, v, dy, dr, dk, dv: (B,S,H,hd) contiguous, float32 (dtype 0) or
// bfloat16 (dtype 1); w, dw: (B,S,H,hd) float32; u: (H,hd) float32;
// s_chunks: (B,H,ceil(S/C),hd,hd) float32 from wkv_fwd_save; ds_final
// (nullable), ds0: (B,H,hd,hd) float32; du_part: (B,H,hd) float32 (the
// caller sums over B); scratch: B*H*wkv_bwd_scratch_floats(hd) float32.
// Launches on `stream`; returns the launch's CUDA error code (0 on success).
extern "C" int wkv_bwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s_chunks,
                       const void* dy, const void* ds_final, void* dr,
                       void* dk, void* dv, void* dw, void* du_part, void* ds0,
                       void* scratch, int B, int S, int H, int hd, int dtype,
                       void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch_hd<float>(hd, r, k, v, w, u, s_chunks, dy, ds_final, dr,
                               dk, dv, dw, du_part, ds0, scratch, B, S, H, st)
          : dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s_chunks, dy,
                                       ds_final, dr, dk, dv, dw, du_part, ds0,
                                       scratch, B, S, H, st);
  return (int)err;
}
