// Mamba selective scan for Hopper (sm_90a), CUDA C++: the streams staged
// by cp.async, the steps of a chunk pipelined, y out as 16-byte rows.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py:49 (selective_scan_tpu,
// Pallas body `_body`).  Same function: for u, dt (B,S,d), A (d,N), B_t,
// C_t (B,S,N) and D (d,),
//     h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t u_t) ⊗ B_t,
//     y_t = h_t · C_t + D ⊙ u_t,
// with h (B,d,N) float32 starting at h0 (zeros when h0 is null).  y comes
// out in u's dtype, with the D ⊙ u term (which the TPU function adds after
// its pallas_call) fused in.  Beyond the TPU kernel, the final state h_S is
// written when h_out is not null: the serving prefill hands it to decode.
// For training, `selective_scan_fwd_save` also writes h at the start of
// every SAVE = 64 steps (the backward, selective_scan_bwd.cu, re-runs each
// such chunk from it), in an instantiation of its own: with that pointer
// null the inference kernel runs, compiled without the store.
// u, dt, B and C are all float32 or all bfloat16; A, D and the state are
// float32 (the wrapper casts D, which is small).  N is 4 or 16; any S >= 0
// and d >= 1.
//
// Not carried over block by block: the Pallas kernel blocks 512 channels x
// 128-step chunks on a sequential grid axis and carries h in VMEM scratch
// from one grid step to the next.  Here blocks run in parallel, so the time
// loop lives inside the block and a channel's N state entries stay in
// registers for the whole sequence.
//
// Bound on the card.  Per (b, t, c) the function reads u and dt and writes
// y; B_t and C_t are shared by the d channels of a batch row.  At the
// serving prefill (B=4, S=1024, d=8192, N=16, f32) that is 3 x 134.2 MB of
// streams plus about 5.3 MB of A, B, C, D, h0 and h_S: 407.9 MB, 0.122 ms
// at 3.35 TB/s.  The arithmetic is B*S*d*N = 537 M state updates of one
// exp and four f32 operations each (dt A, (dt u) B_n, the update and the y
// sum).  On the SFU alone the exps are 16 a clock on an SM: 4.19 M on the
// busiest SM, ~0.132 ms at 1.98 GHz, beside the byte bound.
//
// Design.  A CTA holds CPB = 64 consecutive channels of one batch row (grid
// (ceil(d/64), B)), one thread a channel.  Per step a thread does, for each
// of its N entries, h = h * 2^(dt * A log2 e) + (dt u) B_n and y += h C_n
// (four partial sums), A log2 e taken once.  u and dt reach shared memory
// by 16-byte cp.async, double-buffered in chunks of CH steps (chunk n+1's
// copies in flight while chunk n computes), so bf16 moves half the bytes
// of f32 in the same number of copies; B_t and C_t of the next chunk are
// loaded into registers and written to shared memory as f32 at the end of
// the current one, so every lane reads them as broadcast vector loads.
// Within a whole chunk, step k+1's loads, its exps and its (dt u) B_n are
// issued before step k's updates, so that the exps on the SFU overlap the
// updates' chain of FMAs; y stays in registers until the chunk's end, then
// goes through shared memory and out as 16-byte rows.  One barrier a
// chunk; no atomics, a fixed order of sums: repeats are bit-identical.
// Where d's rows are not 16-byte aligned (d not a multiple of 4 f32 or 8
// bf16 values) the copies and stores go element by element.
//
// Every exp runs on the SFU (ex2.approx).  tools/scan_variants.py measured
// a share of them moved to a polynomial exp2 on the FMA pipe slower, and
// taking the exps away altogether only 6-12% faster, so the SFU is not what
// sets the time here.
//
// What the design leaves: at the prefill shape the f32 time is ~3% below
// the one-thread-a-channel kernel it replaces and bf16 ~25% below it, now
// under f32; the copies and stores alone take ~0.16 ms in f32 and the
// updates alone ~0.19-0.25: with eight warps an SM the per-step
// chain (shared-memory loads, the updates, the y sum) keeps the issue rate
// near half of the SM's.  Splitting a channel over lanes, two channels a
// thread (one load of B and C for both), 32 or 128 channels a CTA, chunks
// of 8 steps, a 3- or 4-chunk ring and y stored from each step measured
// slower or no faster (PERF.md records the times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CPB = 64;              // channels of a CTA
constexpr int CH = 16;               // steps of a staged chunk
constexpr int NSTAGE = 2;            // cp.async ring depth, in chunks
constexpr int SAVE = 64;             // steps between saved states
constexpr float LOG2E = 1.4426950408889634f;

// 2^x rounded by the SFU: about 2 ulp, 0 below -126 (.ftz).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                      // round to nearest even
}

// 16 bytes of y from f32 values in shared memory.
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x, a.y);
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(a.z, a.w);
  const __nv_bfloat162 p2 = __floats2bfloat162_rn(b.x, b.y);
  const __nv_bfloat162 p3 = __floats2bfloat162_rn(b.z, b.w);
  uint4 o;
  o.x = *reinterpret_cast<const uint32_t*>(&p0);
  o.y = *reinterpret_cast<const uint32_t*>(&p1);
  o.z = *reinterpret_cast<const uint32_t*>(&p2);
  o.w = *reinterpret_cast<const uint32_t*>(&p3);
  *reinterpret_cast<uint4*>(dst) = o;
}

// SAVE_H: also write h at every SAVE-th step (training); the inference
// instantiation compiles without that store.
template <typename T, int N, bool SAVE_H = false>
__global__ void __launch_bounds__(CPB)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ Dp,
            const float* __restrict__ h0, T* __restrict__ y,
            float* __restrict__ h_out, float* __restrict__ h_chunks, int S,
            int d) {
  static_assert(SAVE % CH == 0, "saved states at chunk starts");
  static_assert(N % 4 == 0, "B_t and C_t rows are float4 rows");
  constexpr int THREADS = CPB;
  constexpr int VPP = 16 / (int)sizeof(T);       // values of a 16-byte piece
  constexpr int PR = CPB / VPP;                  // pieces of a row
  constexpr int BCT = (2 * CH * N + THREADS - 1) / THREADS;  // B, C a thread
  __shared__ __align__(16) T ud[NSTAGE][2][CH][CPB];   // u, dt
  __shared__ __align__(16) float bc[2][2][CH][N];      // B, C as f32
  __shared__ __align__(16) float ys[2][CH][CPB];       // y before its store

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const bool vec = d % VPP == 0;        // rows of u, dt, y 16-byte aligned
  const size_t row0 = (size_t)b * S;    // (b, 0)
  const int nchunks = (S + CH - 1) / CH;

  // Channels past d compute on channel d - 1 and store nothing.
  const int cc = min(c0 + tid, d - 1);
  float a2[N], h[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    a2[e] = A[(size_t)cc * N + e] * LOG2E;
    h[e] = h0 != nullptr ? h0[((size_t)b * d + cc) * N + e] : 0.f;
  }
  const float dc = Dp[cc];

  // Chunk n's u and dt into stage n % NSTAGE, zeros past S and d; always
  // commits a group.
  auto issue = [&](int n) {
    if (n < nchunks) {
      for (int q = tid; q < 2 * CH * PR; q += THREADS) {
        const int a = q / (CH * PR), row = (q / PR) % CH, pc = q % PR;
        const int t = n * CH + row, ch = c0 + pc * VPP;
        T* dst = &ud[n % NSTAGE][a][row][pc * VPP];
        const T* src = (a ? dt : u) + (row0 + t) * d + ch;
        if (vec) {
          const bool in = t < S && ch < d;
          cp_async16(dst, in ? src : u, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < VPP; ++e)
            dst[e] = t < S && ch + e < d ? src[e] : T(0.f);
        }
      }
    }
    cp_async_commit();
  };
  // Chunk n's B and C: loaded into registers, then written as f32.
  T bcr[BCT];
  auto fetch_bc = [&](int n) {
#pragma unroll
    for (int i = 0; i < BCT; ++i) {
      const int q = tid + i * THREADS;
      const int a = q / (CH * N), t = n * CH + (q / N) % CH;
      bcr[i] = q < 2 * CH * N && t < S
                   ? (a ? Cm : Bm)[(row0 + t) * N + q % N] : T(0.f);
    }
  };
  auto stash_bc = [&](int n) {
#pragma unroll
    for (int i = 0; i < BCT; ++i) {
      const int q = tid + i * THREADS;
      if (q < 2 * CH * N) (&bc[n & 1][0][0][0])[q] = to_f32(bcr[i]);
    }
  };
  // Chunk n's y from shared memory to (b, t, c0..), rows < S, columns < d.
  auto store_y = [&](int n) {
    const int t0 = n * CH;
    if (vec) {
      for (int q = tid; q < CH * PR; q += THREADS) {
        const int row = q / PR, ch = c0 + (q % PR) * VPP;
        if (t0 + row < S && ch < d)
          store16(y + (row0 + t0 + row) * d + ch,
                  &ys[n & 1][row][(q % PR) * VPP]);
      }
    } else {
      for (int q = tid; q < CH * CPB; q += THREADS) {
        const int row = q / CPB, ch = c0 + q % CPB;
        if (t0 + row < S && ch < d)
          from_f32(y + (row0 + t0 + row) * d + ch, ys[n & 1][row][q % CPB]);
      }
    }
  };

#pragma unroll
  for (int n = 0; n < NSTAGE - 1; ++n) issue(n);
  if (nchunks > 0) {
    fetch_bc(0);
    stash_bc(0);
  }
  for (int n = 0; n < nchunks; ++n) {
    // h at every SAVE-th step, (B, ceil(S/SAVE), d, N), for the backward.
    if constexpr (SAVE_H) {
      if (n % (SAVE / CH) == 0 && c0 + tid < d) {
        float* p = h_chunks + (((size_t)b * ((S + SAVE - 1) / SAVE) +
                                n / (SAVE / CH)) * d + c0 + tid) * N;
#pragma unroll
        for (int e = 0; e < N; e += 4)
          *reinterpret_cast<float4*>(p + e) =
              make_float4(h[e], h[e + 1], h[e + 2], h[e + 3]);
      }
    }
    // Chunk n's copies and B, C have landed; chunk n-1 is done with its
    // stage, its B and C buffer and its y buffer's neighbour.
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (n > 0) store_y(n - 1);
    issue(n + NSTAGE - 1);
    if (n + 1 < nchunks) fetch_bc(n + 1);
    const int stage = n % NSTAGE;
    const int steps = min(CH, S - n * CH);
    // A step's inputs and all of its work that does not need h: u, the
    // decays 2^(dt A log2 e), (dt u) B_n and C_t.
    struct In { float u, bu[N], c[N], da[N]; };
    auto load = [&](int k, In& in) {
      in.u = to_f32(ud[stage][0][k][tid]);
      const float dt = to_f32(ud[stage][1][k][tid]);
      const float dtu = dt * in.u;
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        const float4 p = *reinterpret_cast<const float4*>(&bc[n & 1][0][k][e]);
        const float4 q = *reinterpret_cast<const float4*>(&bc[n & 1][1][k][e]);
        in.bu[e] = dtu * p.x; in.bu[e + 1] = dtu * p.y;
        in.bu[e + 2] = dtu * p.z; in.bu[e + 3] = dtu * p.w;
        in.c[e] = q.x; in.c[e + 1] = q.y; in.c[e + 2] = q.z; in.c[e + 3] = q.w;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) in.da[e] = ex2_approx(dt * a2[e]);
    };
    // One step's N updates and its y: four partial sums, then D u.
    auto update = [&](const In& in) {
      float yp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < N; ++e) {
        h[e] = fmaf(h[e], in.da[e], in.bu[e]);
        yp[e % 4] = fmaf(h[e], in.c[e], yp[e % 4]);
      }
      return fmaf(dc, in.u, (yp[0] + yp[1]) + (yp[2] + yp[3]));
    };
    auto put = [&](int k, float yv) { ys[n & 1][k][tid] = yv; };
    if (steps == CH) {
      // A whole chunk: step k+1's loads, decays and (dt u) B_n issued
      // before step k's updates, y kept in registers and stored after the
      // last step, so that no shared-memory store stands between one step
      // and the next.
      float yk[CH];
      In cur, nxt;
      load(0, cur);
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        if (k + 1 < CH) load(k + 1, nxt);
        yk[k] = update(cur);
        if (k + 1 < CH) cur = nxt;
      }
#pragma unroll
      for (int k = 0; k < CH; ++k) put(k, yk[k]);
    } else {
      for (int k = 0; k < steps; ++k) {        // the ragged last chunk
        In in;
        load(k, in);
        put(k, update(in));
      }
    }
    if (n + 1 < nchunks) stash_bc(n + 1);
  }
  if (nchunks > 0) {
    __syncthreads();
    store_y(nchunks - 1);
  }

  if (h_out != nullptr && c0 + tid < d) {
    float* p = h_out + ((size_t)b * d + c0 + tid) * N;
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(h[e], h[e + 1], h[e + 2], h[e + 3]);
  }
}

// The whole carveout for shared memory, so that four CTAs (28 KB each in
// f32) share an SM.
template <typename T, int N, bool SAVE_H = false>
cudaError_t set_attributes() {
  return cudaFuncSetAttribute(scan_kernel<T, N, SAVE_H>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int N, bool SAVE_H>
cudaError_t launch_as(const void* u, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* Dp,
                      const void* h0, void* y, void* h_out, void* h_chunks,
                      int B, int S, int d, cudaStream_t st) {
  const cudaError_t err = set_attributes<T, N, SAVE_H>();
  if (err != cudaSuccess) return err;
  const dim3 grid((d + CPB - 1) / CPB, B);
  scan_kernel<T, N, SAVE_H><<<grid, CPB, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), static_cast<float*>(h_chunks), S, d);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* Dp,
                   const void* h0, void* y, void* h_out, void* h_chunks,
                   int B, int S, int d, cudaStream_t st) {
  return h_chunks != nullptr
             ? launch_as<T, N, true>(u, dt, A, Bm, Cm, Dp, h0, y, h_out,
                                     h_chunks, B, S, d, st)
             : launch_as<T, N, false>(u, dt, A, Bm, Cm, Dp, h0, y, h_out,
                                      h_chunks, B, S, d, st);
}

template <typename T>
cudaError_t dispatch_n(int N, const void* u, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* Dp,
                       const void* h0, void* y, void* h_out, void* h_chunks,
                       int B, int S, int d, cudaStream_t st) {
  switch (N) {
    case 4: return launch<T, 4>(u, dt, A, Bm, Cm, Dp, h0, y, h_out, h_chunks,
                                B, S, d, st);
    case 16: return launch<T, 16>(u, dt, A, Bm, Cm, Dp, h0, y, h_out, h_chunks,
                                  B, S, d, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// u, dt, y: (B,S,d) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// Bm, Cm: (B,S,N) of the same dtype, N = 4 (the smoke configs) or 16; A:
// (d,N) float32; Dp: (d,) float32; h0 (nullable), h_out (nullable): (B,d,N)
// float32; h_chunks (nullable): (B,ceil(S/64),d,N) float32; all 16-byte
// aligned.  Launches on `stream`; returns the launch's CUDA error code (0 on
// success).
extern "C" int selective_scan_fwd_save(const void* u, const void* dt,
                                       const void* A, const void* Bm,
                                       const void* Cm, const void* Dp,
                                       const void* h0, void* y, void* h_out,
                                       void* h_chunks, int B, int S, int d,
                                       int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || d <= 0 || S < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch_n<float>(N, u, dt, A, Bm, Cm, Dp, h0, y, h_out, h_chunks,
                              B, S, d, st)
          : dispatch_n<__nv_bfloat16>(N, u, dt, A, Bm, Cm, Dp, h0, y, h_out,
                                      h_chunks, B, S, d, st);
  return (int)err;
}

// The inference forward: selective_scan_fwd_save without the saved states.
extern "C" int selective_scan_fwd(const void* u, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* Dp,
                                  const void* h0, void* y, void* h_out, int B,
                                  int S, int d, int N, int dtype,
                                  void* stream) {
  return selective_scan_fwd_save(u, dt, A, Bm, Cm, Dp, h0, y, h_out, nullptr,
                                 B, S, d, N, dtype, stream);
}

// Steps between the saved states.
extern "C" int selective_scan_save_steps() { return SAVE; }
