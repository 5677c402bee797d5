// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), CUDA C++ with plain f32
// FMA.
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:71 (wkv_tpu, Pallas body
// `_body`).  Same function: for r, k, v, w (B,S,H,hd), the bonus u (H,hd)
// and an initial state S_0 (B,H,hd,hd) float32 [key x value],
//     y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T),
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// returning y (B,S,H,hd) in r's dtype and the final state S_S in float32
// (the prefill hands it to decode).  r, k, v and y are float32 or bfloat16;
// w, u and the state are float32 (the wrapper casts u, which is small).
//
// Not carried over block by block: the Pallas body builds a (C, C, hd)
// decay tensor from a cumulative sum of log w so that a chunk's work lands
// on the TPU's matrix unit.  Here the recurrence runs step by step, as the
// reference's per-step form does: no log, no exp, no atomics, and a fixed
// summation order, so the result is deterministic.  Any S >= 0.
//
// Bound on the card.  Per (b, h, t) the function reads hd values each of
// r, k, v, w and writes hd of y, and does 4 operations per state entry.
// At the serving prefill (B=4, S=1024, H=64, hd=64, f32) that is 335.5 MB of
// streams plus 2 x 4.2 MB of state in and out, 0.103 ms at 3.35 TB/s,
// against 4.29 GFLOP, 0.064 ms at 67 TFLOP/s: bound by bytes.  The time
// steps are serial, though, so what sets this kernel's time is the
// instructions each step issues: 3 per state entry (y += r S, x = k v,
// S = S w + x) plus the loads and the reduction of y.
//
// Design.  One CTA per (b, h) of 4 * hd threads.  The lanes of a warp split
// the state's rows (keys): lane li of a group of LR = 16 lanes owns rows
// li*RL .. li*RL+RL-1, and the group owns CJ consecutive value columns, so
// each thread holds an RL x CJ block of the state in registers for all S
// steps, beside its rows of u.  Per step a thread reads its rows of r, k, w
// (one vector load each) and the group's CJ values of v (a broadcast), and
// computes partial sums of y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i
// over its rows; a reduce-scatter across the LR lanes (each level swaps
// half of the remaining partial sums with the partner lane) leaves one
// column's y on each lane, which writes it.  Splitting rows across lanes
// and keeping several columns per thread makes every shared-memory read
// feed CJ or RL updates.  (This file's first version gave each value
// column four threads of hd/4 rows, so every thread re-read r, k, w for
// its one column each step; it took 1.5x as long at the prefill shape.)
// What is left is the latency of each step's chain (loads, updates, four
// shuffle levels): with 16 warps on an SM too few steps are in flight to
// hide it.
//
// The streams r, k, v, w are staged in shared memory in chunks of CH time
// steps, double-buffered: thread a * hd + i stages element i of stream a;
// the loads of chunk n+1 go into registers before chunk n is computed and
// into the other buffer after it, so there is one __syncthreads per chunk
// and a chunk of work hides each load.  The state is read at the start and
// written at the end.
//
// What the simple design leaves: the chunked tensor-core form (wgmma on
// C x C tiles), which makes the work within a chunk parallel in time, and
// more CTAs than B * H (value-column slices) when the batch is small.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// One element's raw bits: float32 as is, bfloat16 in the low half.  They
// stay raw until the store into shared memory, so a load in flight does not
// stall the thread before the chunk that needs it.
__device__ __forceinline__ uint32_t load_raw(const void* base, size_t idx,
                                             bool f32) {
  if (f32) return __ldg(static_cast<const unsigned int*>(base) + idx);
  return static_cast<uint32_t>(
      __ldg(static_cast<const unsigned short*>(base) + idx));
}

__device__ __forceinline__ float raw_to_f32(uint32_t bits, bool f32) {
  return __uint_as_float(f32 ? bits : bits << 16);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                   // round to nearest even
}

// N consecutive floats from shared memory (N = 1, 2, 4 or 8; aligned).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 1) {
    out[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      out[q] = a.x; out[q + 1] = a.y; out[q + 2] = a.z; out[q + 3] = a.w;
    }
  }
}

template <int CH>
__device__ __forceinline__ void fetch(uint32_t (&pre)[CH], const void* src,
                                      size_t base, size_t step, int t0,
                                      int S, bool f32) {
#pragma unroll
  for (int c = 0; c < CH; ++c)
    pre[c] = t0 + c < S ? load_raw(src, base + (size_t)(t0 + c) * step, f32)
                        : 0u;
}

template <int CH, int HD>
__device__ __forceinline__ void stash(float (*dst)[HD],
                                      const uint32_t (&pre)[CH], int i,
                                      bool f32) {
#pragma unroll
  for (int c = 0; c < CH; ++c) dst[c][i] = raw_to_f32(pre[c], f32);
}

// Thread layout for head dim HD: LR lanes per group (a group spans all HD
// rows), RL rows per lane, GPW groups per warp, CJ value columns per
// group; 4 * HD threads in all, so that each stages one stream element.
// At hd 64: groups of 16 lanes, 4 rows x 4 columns of the state per lane.
template <int HD> struct Layout {
  static constexpr int LR = 16;
  static constexpr int RL = HD / LR;
  static constexpr int GPW = 32 / LR;
  static constexpr int CJ = 8 / GPW;
  static constexpr int THREADS = 4 * HD;
  static_assert(HD / (GPW * CJ) * 32 == THREADS, "layout");
  static_assert(CJ <= LR, "reduce-scatter needs CJ <= LR");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  using L = Layout<HD>;
  constexpr int RL = L::RL, LR = L::LR, CJ = L::CJ;
  constexpr int CH = HD >= 128 ? 8 : 16;   // time steps per staged chunk
  // [buffer][stream r, k, v, w][step in chunk][element]
  __shared__ __align__(16) float buf[2][4][CH][HD];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int li = lane % LR;                // row block of this lane
  const int row0 = li * RL;
  const int col0 = (tid / LR) * CJ;        // first value column of the group
  const int a = tid / HD;                  // staging: stream a, element ia
  const int ia = tid % HD;
  const size_t step = (size_t)H * HD;      // between time steps
  const size_t base = ((size_t)b * S * H + h) * HD;   // (b, 0, h, 0)
  const void* src = a == 0 ? static_cast<const void*>(r)
                  : a == 1 ? static_cast<const void*>(k)
                  : a == 2 ? static_cast<const void*>(v)
                           : static_cast<const void*>(w);
  const bool f32 = a == 3 || sizeof(T) == 4;

  float st[RL][CJ], uu[RL];
  const float* s0p = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    uu[q] = u[(size_t)h * HD + row0 + q];
    load_vec<CJ>(s0p + (size_t)(row0 + q) * HD + col0, st[q]);
  }

  uint32_t pre[CH];
  fetch<CH>(pre, src, base + ia, step, 0, S, f32);
  stash<CH, HD>(buf[0][a], pre, ia, f32);
  __syncthreads();

  // After the reduce-scatter, this lane holds column col0 + mine; lanes
  // whose low bits (below LR / CJ) are 0 write it.
  int mine = 0;
#pragma unroll
  for (int o = LR / 2, m = CJ; m > 1; o /= 2, m /= 2)
    if (li & o) mine += m / 2;
  const bool writer = (li % (LR / CJ)) == 0;

  const int nchunks = (S + CH - 1) / CH;
  for (int n = 0; n < nchunks; ++n) {
    const int slot = n & 1;
    const int t0 = n * CH;
    const bool more = n + 1 < nchunks;
    if (more) fetch<CH>(pre, src, base + ia, step, t0 + CH, S, f32);
    const int steps = min(CH, S - t0);
    // Unrolled by two: one step's reduction overlaps the next step's
    // updates, which do not wait for it.
#pragma unroll 2
    for (int c = 0; c < steps; ++c) {
      float rr[RL], kk[RL], ww[RL], vv[CJ], yp[CJ];
      load_vec<RL>(&buf[slot][0][c][row0], rr);
      load_vec<RL>(&buf[slot][1][c][row0], kk);
      load_vec<CJ>(&buf[slot][2][c][col0], vv);
      load_vec<RL>(&buf[slot][3][c][row0], ww);
      float ruk = 0.f;                         // sum_i r_i u_i k_i, my rows
#pragma unroll
      for (int q = 0; q < RL; ++q) ruk = fmaf(rr[q] * uu[q], kk[q], ruk);
#pragma unroll
      for (int j = 0; j < CJ; ++j) yp[j] = vv[j] * ruk;
#pragma unroll
      for (int q = 0; q < RL; ++q) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          yp[j] = fmaf(rr[q], st[q][j], yp[j]);          // S_{t-1}
          st[q][j] = fmaf(st[q][j], ww[q], kk[q] * vv[j]);
        }
      }
      // Reduce-scatter across the LR lanes: at offset o each lane keeps
      // half of its m partial sums (the upper half if its bit o is set)
      // and adds the partner's; once one is left, plain butterfly sums.
#pragma unroll
      for (int o = LR / 2, m = CJ; o >= 1; o /= 2, m = m > 1 ? m / 2 : 1) {
        if (m > 1) {
          const bool up = li & o;
#pragma unroll
          for (int j = 0; j < m / 2; ++j) {
            const float send = up ? yp[j] : yp[j + m / 2];
            const float keep = up ? yp[j + m / 2] : yp[j];
            yp[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        } else {
          yp[0] += __shfl_xor_sync(0xffffffffu, yp[0], o);
        }
      }
      if (writer)
        store_out(y + base + (size_t)(t0 + c) * step + col0 + mine, yp[0]);
    }
    if (more) {
      // The other buffer was last read in chunk n-1, before the barrier
      // that ended it.
      stash<CH, HD>(buf[slot ^ 1][a], pre, ia, f32);
      __syncthreads();
    }
  }

  float* sop = s_out + (size_t)bh * HD * HD;
#pragma unroll
  for (int q = 0; q < RL; ++q) {
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      sop[(size_t)(row0 + q) * HD + col0 + j] = st[q][j];
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int S, int H, cudaStream_t st) {
  wkv_kernel<T, HD><<<B * H, Layout<HD>::THREADS, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_out, int B, int S, int H,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y: (B,S,H,hd) contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); w: (B,S,H,hd) float32; u: (H,hd) float32; s0, s_out:
// (B,H,hd,hd) float32.  Launches on `stream`; returns the launch's CUDA
// error code (0 on success).
extern "C" int wkv_fwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* y,
                       void* s_out, int B, int S, int H, int hd, int dtype,
                       void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch_hd<float>(hd, r, k, v, w, u, s0, y, s_out, B, S, H, st)
          : dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, s_out, B,
                                       S, H, st);
  return (int)err;
}
