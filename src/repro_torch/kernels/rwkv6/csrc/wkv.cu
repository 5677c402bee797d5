// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), CUDA C++: the chunked
// form, its products on the tensor cores in 3xTF32 (mma.sync m16n8k8).
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:71 (wkv_tpu, Pallas body
// `_body`).  Same function: for r, k, v, w (B,S,H,hd), the bonus u (H,hd)
// and an initial state S_0 (B,H,hd,hd) float32 [key x value],
//     y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T),
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// returning y (B,S,H,hd) in r's dtype and the final state S_S in float32
// (the prefill hands it to decode).  r, k, v and y are float32 or bfloat16;
// w, u and the state are float32 (the wrapper casts u, which is small).
// Any S >= 0; hd 16, 32, 64 or 128.
//
// Bound on the card.  Per (b, h, t) the function reads hd values each of
// r, k, v, w and writes hd of y, and does 4 operations per state entry.
// At the serving prefill (B=4, S=1024, H=64, hd=64, f32) that is 335.5 MB of
// streams plus 2 x 4.2 MB of state in and out, 0.103 ms at 3.35 TB/s,
// against 4.29 GFLOP, run below as 3xTF32 products: 0.026 ms at 495
// TFLOP/s (0.064 ms of f32 FMA at 67 TFLOP/s): bound by bytes.  Step by
// step, though, the time steps are serial and every step issues 3
// operations per state entry (3.2 G thread-operations, ~0.11 ms of FMA
// issue on 132 SMs before any latency), so only a form that is parallel in
// time within a chunk can reach the byte bound.
//
// Design.  The chunked closed form the TPU kernel computes
// (src/repro/kernels/rwkv6/kernel.py:1-13), over chunks of C = 32 steps
// (16 at hd 128) split into sub-chunks of L = 16 (one m16 tile of rows).
// With the decay products taken from a chunk's start, a sub-chunk's start
// b_j and end e_j,
//   y_t  = (r_t ⊙ Π_{m<t} w_m) S_0                        inter-chunk
//        + Σ_{s<t} Σ_i r_ti k_si Π_{s<m<t} w_mi · v_s     intra-chunk
//        + (r_t · (u ⊙ k_t)) v_t                          the bonus
//   S_C  = diag(Π_m w_m) S_0 + Σ_s (k_s ⊙ Π_{m>s} w_m) v_s^T.
// Factoring a score as (r ⊙ e^{cum})·(k ⊙ e^{-cum}) across a chunk
// overflows f32 (the model's w = exp(-exp(x)) can be tiny or 0), so every
// factor here is a product of decays taken from a boundary:
// Qs_t = r_t ⊙ Π_{b_j<=m<t} w_m and Ks_s = k_s ⊙ Π_{s<m<=e_i} w_m, one
// running product along time per channel (no log, no exp: the products
// are the per-step form's own, so w = 0 gives exactly 0; an underflow to
// 0 stands for a true value below 1e-38).  A score between query
// sub-chunk j and an earlier key sub-chunk i is (Qs_t ⊙ D_ij)·Ks_s, D_ij
// the whole sub-chunks strictly between them, every factor <= 1; the inter
// term is (Qs_t ⊙ Π_{m<b_j} w_m)·S_0 and the state update's keys
// Ks_s ⊙ Π_{m>e_i} w_m, the factors applied to the fragments in registers.
// The diagonal blocks (s and t in one sub-chunk) factor as Qs_t·(Ks_s /
// W_i), W_i the sub-chunk's total, when every W_i of the chunk is at least
// FAST_MIN = 1e-20 (then 1 / W_i <= 1e20 and nothing overflows): a vote in
// the chunk's second barrier.  Where decays near 0 make a W_i smaller,
// the chunk takes its diagonal blocks pairwise on the CUDA cores instead:
// per (key s, channel) a running product over the later queries of the
// sub-chunk, summed over channels by a reduce-scatter across lanes.
// Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8):
// each f32 operand is split into big = tf32(x) and small = tf32(x - big)
// and a product is big·small + small·big + big·big (small·small dropped,
// ~2^-22 relative; bf16 v is exact in TF32 and takes two), the small terms
// and the even and odd k-steps in accumulators of their own so that the
// mma chains interleave.  The state update sums each chunk's product from
// zero and adds it to diag(decay) S in IEEE f32, so the tensor cores'
// truncating accumulation never runs over the whole sequence.
//
// One CTA per (b, h), 8 warps at hd >= 32 (2 at hd 16).  The state lives
// in registers as the accumulators of the update product and is copied to
// shared memory each chunk, where the inter-chunk product reads it.  The
// chunks of r, k, w and v reach shared memory by cp.async, STAGES deep:
// chunk n+1's copies are in flight while chunk n computes.  Per chunk:
// (1) running products (Qs, Ks, sub-chunk totals) and the bonus of every
// step; (2) the inter-chunk product into y's accumulators and the score
// blocks (pairwise diagonal blocks first where the vote says so); (3) y +=
// A v, stored, and the state update.  Three barriers a chunk, no atomics,
// a fixed order of sums: repeats are bit-identical.  At hd 64 a CTA takes
// 106 KB of shared memory, so two CTAs share an SM and the 256 CTAs of
// the serving prefill are all resident at once.
//
// What the design leaves (tools/wkv_variants.py measures it): the
// mma.sync chains and the three barriers a chunk, not the bytes, set the
// time (at the prefill shape the copies alone take 0.123 ms, the products
// add ~0.15); wgmma on 64-row tiles with a producer warp feeding a TMA
// ring would take the products off the per-chunk critical path.  Chunks of
// 64 steps, a 3-stage ring or a split of the value columns over 2 or 4
// CTAs (each recomputing the scores) measured slower: they cost the
// second CTA an SM or add work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int L = 16;            // steps of a sub-chunk: one m16 row tile

// A chunk whose sub-chunk decay products are all at least FAST_MIN takes
// its diagonal score blocks on the tensor cores (phase 2c); below it, on
// the CUDA cores pairwise (phase 2a).
constexpr float FAST_MIN = 1e-20f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <typename T, int HD> struct Cfg {
  static constexpr int C = HD >= 128 ? 16 : 32;   // steps of a chunk
  static constexpr int STAGES = 2;                // cp.async ring depth
  static constexpr int NSUB = C / L;
  static constexpr int NT_S = HD / 8, TILES_S = (HD / 16) * NT_S;
  static constexpr int NT_Y = HD / 8, TILES_Y = (C / 16) * NT_Y;
  static constexpr int NW = cmin(8, cmin(TILES_S, TILES_Y));
  static constexpr int NT = NW * 32;
  static constexpr int TPW_S = TILES_S / NW;      // state tiles of a warp
  static constexpr int TPW_Y = TILES_Y / NW;      // y tiles of a warp
  static constexpr int NG = HD >= 32 ? 8 : 4;     // lanes of a diagonal item
  static constexpr int GC = HD / NG;              // its channels (4 per float4)
  // Row strides in elements, padded so that fragment loads are free of
  // bank conflicts: A fragments read rows g and columns tq (stride = 4 mod
  // 32), B fragments rows tq and columns g (stride = 8 mod 32 words).
  static constexpr int QSTR = HD + 4;             // Qs, Ks [step][channel]
  static constexpr int ASTR = C + 4;              // A [query][key]
  static constexpr int SSTR = HD + 8;             // S [key][value column]
  static constexpr int VSTR = HD + 32 / (int)sizeof(T);  // v [step][column]
  static constexpr int R_BYTES = C * HD * (int)sizeof(T);
  static constexpr int W_BYTES = C * HD * 4;
  static constexpr int V_BYTES = C * VSTR * (int)sizeof(T);
  static constexpr int STAGE_BYTES = 2 * R_BYTES + W_BYTES + V_BYTES;
  static constexpr int OFF_QS = STAGES * STAGE_BYTES;
  static constexpr int OFF_KS = OFF_QS + C * QSTR * 4;
  static constexpr int OFF_A = OFF_KS + C * QSTR * 4;
  static constexpr int OFF_S = OFF_A + C * ASTR * 4;
  static constexpr int OFF_W = OFF_S + HD * SSTR * 4;
  static constexpr int OFF_U = OFF_W + NSUB * HD * 4;
  static constexpr int SMEM = OFF_U + C * 4;
  static_assert(NT_Y % TPW_Y == 0 && NT_S % TPW_S == 0,
                "a warp's tiles share one row tile");
  static_assert(GC % 4 == 0 && L % NG == 0, "diagonal items");
  static_assert(C % NW == 0 && C / NW <= 32, "bonus rows of a warp");
};

// x = big + small + O(2^-22 |x|): big = tf32(x), small = tf32(x - big),
// rounded to nearest (ties away from zero) by adding half of the 13 bits
// the tensor cores ignore; only big, which the subtraction needs exactly,
// is masked.  EXACT (bf16 values, which TF32 holds exactly): no small.
template <bool EXACT = false>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  if constexpr (!EXACT)
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

template <bool EXACT = false>
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split<EXACT>(x[e], big[e], small[e]);
}

// D += A B for one m16n8k8 TF32 tile: A (16x8) a0 = A[g][tq], a1 = A[g+8][tq],
// a2 = A[g][tq+4], a3 = A[g+8][tq+4]; B (8x8) b0 = B[tq][g], b1 = B[tq+4][g];
// D d0, d1 = D[g][2tq, 2tq+1], d2, d3 = D[g+8][2tq, 2tq+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 product: the small terms into `sm`, big·big into `bg`, two
// accumulators so that the three products do not wait on each other (the
// caller adds them); B_EXACT: B has no small part.
template <bool B_EXACT = false>
__device__ __forceinline__ void mma3(float (&bg)[4], float (&sm)[4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(sm, as, bb0, bb1);
  if constexpr (!B_EXACT) mma_tf32(sm, ab, bs0, bs1);
  mma_tf32(bg, ab, bb0, bb1);
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}
// Four consecutive elements (16-byte aligned f32, 8-byte aligned bf16).
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* o) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(a.x << 16); o[1] = __uint_as_float(a.x & 0xffff0000u);
  o[2] = __uint_as_float(a.y << 16); o[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// SAVE_S: also write the state at every chunk start (training); the
// inference instantiation compiles without that store.
template <typename T, int HD, bool SAVE_S = false>
__global__ void __launch_bounds__(Cfg<T, HD>::NT, HD <= 64 ? 2 : 1)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s_out,
           float* __restrict__ s_chunks, int S, int H) {
  using P = Cfg<T, HD>;
  constexpr int C = P::C, NSUB = P::NSUB, NT = P::NT, NG = P::NG;
  constexpr int GC = P::GC, QSTR = P::QSTR, ASTR = P::ASTR, SSTR = P::SSTR;
  constexpr int VSTR = P::VSTR, STAGES = P::STAGES;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + P::OFF_QS);
  float* Ks = reinterpret_cast<float*>(smem + P::OFF_KS);
  float* Am = reinterpret_cast<float*>(smem + P::OFF_A);
  float* Ss = reinterpret_cast<float*>(smem + P::OFF_S);
  float* Wt = reinterpret_cast<float*>(smem + P::OFF_W);
  float* Ud = reinterpret_cast<float*>(smem + P::OFF_U);
  constexpr int UL = (HD + 31) / 32;        // channels of a lane in (1b)

  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t row_step = (size_t)H * HD;            // between time steps
  const size_t base = ((size_t)b * S * H + h) * HD;  // (b, 0, h, 0)
  const int nchunks = (S + C - 1) / C;

  // This warp's tiles: state rows sm0.., columns sn0 + 8i; y rows ym0..
  // of a chunk, columns yn0 + 8i.
  const int sm0 = (warp * P::TPW_S / P::NT_S) * 16;
  const int sn0 = (warp * P::TPW_S % P::NT_S) * 8;
  const int ym0 = (warp * P::TPW_Y / P::NT_Y) * 16;
  const int yn0 = (warp * P::TPW_Y % P::NT_Y) * 8;

  float st[P::TPW_S][4];
  {
    const float* p = s0 + (size_t)bh * HD * HD;
#pragma unroll
    for (int i = 0; i < P::TPW_S; ++i) {
      const int n = sn0 + 8 * i + 2 * tq;
      const float2 lo = *reinterpret_cast<const float2*>(
          p + (size_t)(sm0 + g) * HD + n);
      const float2 hi = *reinterpret_cast<const float2*>(
          p + (size_t)(sm0 + g + 8) * HD + n);
      st[i][0] = lo.x; st[i][1] = lo.y; st[i][2] = hi.x; st[i][3] = hi.y;
      store2(Ss + (sm0 + g) * SSTR + n, lo.x, lo.y);
      store2(Ss + (sm0 + g + 8) * SSTR + n, hi.x, hi.y);
    }
  }
  // u at this lane's channels lane + 32 q of the bonus.
  float ul[UL];
#pragma unroll
  for (int q = 0; q < UL; ++q)
    ul[q] = lane + 32 * q < HD ? u[(size_t)h * HD + lane + 32 * q] : 0.f;

  // Chunk n's r, k, w rows and v's columns into stage n % STAGES; rows
  // past S are zero-filled.  Always commits a group, so that the wait
  // below counts the same every chunk.
  auto issue = [&](int n) {
    if (n < nchunks) {
      unsigned char* stg = smem + (n % STAGES) * P::STAGE_BYTES;
      constexpr int RCH = HD * (int)sizeof(T) / 16, WCH = HD / 4;
      constexpr int N_R = C * RCH, N_W = C * WCH, N_V = C * RCH;
      const int t0 = n * C;
      for (int q = tid; q < 2 * N_R + N_W + N_V; q += NT) {
        const char* src;
        unsigned char* dst;
        int row;
        if (q < 2 * N_R) {
          const int a = q / N_R, rq = q % N_R;
          row = rq / RCH;
          src = reinterpret_cast<const char*>((a ? k : r) + base +
                                              (size_t)(t0 + row) * row_step)
                + (rq % RCH) * 16;
          dst = stg + a * P::R_BYTES + row * HD * (int)sizeof(T)
                + (rq % RCH) * 16;
        } else if (q < 2 * N_R + N_W) {
          const int wq = q - 2 * N_R;
          row = wq / WCH;
          src = reinterpret_cast<const char*>(w + base +
                                              (size_t)(t0 + row) * row_step)
                + (wq % WCH) * 16;
          dst = stg + 2 * P::R_BYTES + row * HD * 4 + (wq % WCH) * 16;
        } else {
          const int vq = q - 2 * N_R - N_W;
          row = vq / RCH;
          src = reinterpret_cast<const char*>(v + base +
                                              (size_t)(t0 + row) * row_step)
                + (vq % RCH) * 16;
          dst = stg + 2 * P::R_BYTES + P::W_BYTES
                + row * VSTR * (int)sizeof(T) + (vq % RCH) * 16;
        }
        const bool in = t0 + row < S;
        cp_async16(dst, in ? src : reinterpret_cast<const char*>(w),
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) issue(n);

  for (int n = 0; n < nchunks; ++n) {
    // The state at chunk n's start, (B,H,nchunks,hd,hd), for the backward.
    if constexpr (SAVE_S) {
      float* cp = s_chunks + ((size_t)bh * nchunks + n) * HD * HD;
#pragma unroll
      for (int i = 0; i < P::TPW_S; ++i) {
        const int n2 = sn0 + 8 * i + 2 * tq;
        store2(cp + (size_t)(sm0 + g) * HD + n2, st[i][0], st[i][1]);
        store2(cp + (size_t)(sm0 + g + 8) * HD + n2, st[i][2], st[i][3]);
      }
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk n landed; chunk n-1 is done with its stage
    issue(n + STAGES - 1);
    const unsigned char* stg = smem + (n % STAGES) * P::STAGE_BYTES;
    const T* rs = reinterpret_cast<const T*>(stg);
    const T* ks = reinterpret_cast<const T*>(stg + P::R_BYTES);
    const float* ws = reinterpret_cast<const float*>(stg + 2 * P::R_BYTES);
    const T* vs = reinterpret_cast<const T*>(stg + 2 * P::R_BYTES +
                                             P::W_BYTES);
    const int steps = min(C, S - n * C);

    // (1a) Running products along time, one (direction, sub-chunk,
    // channel) per item: Qs from each sub-chunk's start (and its total
    // in Wt), Ks to its end.  Rows past S decay by 1.  A thread's vote
    // `fast`: every sub-chunk total it took is at least FAST_MIN.
    bool fast = true;
    for (int it = tid; it < 2 * NSUB * HD; it += NT) {
      const int ch = it % HD, sub = (it / HD) % NSUB, t0 = sub * L;
      float p = 1.f;
      if (it < NSUB * HD) {
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const int t = t0 + j;
          Qs[t * QSTR + ch] = ld1(rs + t * HD + ch) * p;
          p *= t < steps ? ws[t * HD + ch] : 1.f;
        }
        Wt[sub * HD + ch] = p;
        fast = fast && p >= FAST_MIN;
      } else {
#pragma unroll
        for (int j = L - 1; j >= 0; --j) {
          const int t = t0 + j;
          Ks[t * QSTR + ch] = ld1(ks + t * HD + ch) * p;
          p *= t < steps ? ws[t * HD + ch] : 1.f;
        }
      }
    }
    // (1b) The bonus r_t · (u ⊙ k_t) of every step: a warp takes C / NW
    // steps at once, their butterfly sums interleaved.
    {
      constexpr int RPW = C / P::NW;
      float d[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int t = warp + i * P::NW;
        d[i] = 0.f;
#pragma unroll
        for (int q = 0; q < UL; ++q)
          if (lane + 32 * q < HD)
            d[i] = fmaf(ld1(rs + t * HD + lane + 32 * q) * ul[q],
                        ld1(ks + t * HD + lane + 32 * q), d[i]);
      }
#pragma unroll
      for (int lvl = 0; lvl < 5; ++lvl) {
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          d[i] += __shfl_xor_sync(0xffffffffu, d[i], 16 >> lvl);
      }
      if (lane < RPW) {
        float mine = d[0];
#pragma unroll
        for (int i = 1; i < RPW; ++i) mine = lane == i ? d[i] : mine;
        Ud[warp + lane * P::NW] = mine;
      }
    }
    // Fast: every sub-chunk's decays multiply to >= FAST_MIN in every
    // channel, so Ks_s / W_i = k_s / Π_{b_i<=m<=s} w_m stays below
    // |k| / FAST_MIN and the diagonal blocks factor too.
    fast = __syncthreads_and(fast);

    // (2a) The diagonal blocks of A pairwise on the CUDA cores, where a
    // sub-chunk's decays may underflow: one (sub-chunk, key s, channel
    // group) per item, column s of the block, A[t][s] = Σ_i r_ti k_si
    // Π_{s<m<t} w_mi below the diagonal, the bonus on it, 0 above; a
    // group's lanes hold channels grp*4 + 4*NG*q + e and sum them by a
    // reduce-scatter.
    for (int it = tid; !fast && it < NSUB * L * NG; it += NT) {
      const int grp = it % NG, s = (it / NG) % L, t0 = (it / (NG * L)) * L;
      float kk[GC], rr[GC], p[L];
#pragma unroll
      for (int q = 0; q < GC / 4; ++q)
        ld4(ks + (t0 + s) * HD + grp * 4 + q * 4 * NG, kk + 4 * q);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (j <= s) {
          p[j] = 0.f;
        } else {
          float ww[GC];
#pragma unroll
          for (int q = 0; q < GC / 4; ++q) {
            ld4(rs + (t0 + j) * HD + grp * 4 + q * 4 * NG, rr + 4 * q);
            ld4(ws + (t0 + j) * HD + grp * 4 + q * 4 * NG, ww + 4 * q);
          }
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < GC; ++c) {
            d = fmaf(rr[c], kk[c], d);
            kk[c] *= ww[c];
          }
          p[j] = d;
        }
      }
      // Reduce-scatter over the NG lanes: each level keeps half of the m
      // partial sums (the upper half where the lane's bit o is set) and
      // adds the partner's; L / NG sums are left, rows off.. of column s.
      int off = 0;
#pragma unroll
      for (int lvl = 0; (NG >> lvl) > 1; ++lvl) {
        const int o = NG >> (lvl + 1), m = L >> lvl;
        const bool up = grp & o;
#pragma unroll
        for (int j = 0; j < m / 2; ++j) {
          const float lo = p[j], hi = p[j + m / 2];
          const float send = up ? lo : hi, keep = up ? hi : lo;
          p[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
        if (up) off += m / 2;
      }
#pragma unroll
      for (int q = 0; q < L / NG; ++q) {
        const int t = off + q;
        Am[(t0 + t) * ASTR + t0 + s] = t == s ? Ud[t0 + t] : p[q];
      }
    }
    // (2b) y = (Qs ⊙ Π_{m<b_j} w_m) S_n, S_n from shared memory; even and
    // odd k-steps, big·big and small terms in accumulators of their own
    // (four chains a tile), summed after.
    float acc[P::TPW_Y][4], acs[P::TPW_Y][4];   // big·big, small terms
    {
      float pb[2][P::TPW_Y][4], ps[2][P::TPW_Y][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int i = 0; i < P::TPW_Y; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) pb[h2][i][e] = ps[h2][i][e] = 0.f;
      const int jsub = ym0 / L;
#pragma unroll
      for (int kc = 0; kc < HD; kc += 8) {
        const int c0 = kc + tq, c1 = c0 + 4, h2 = kc / 8 % 2;
        float f0 = 1.f, f1 = 1.f;
#pragma unroll
        for (int i = 0; i < NSUB - 1; ++i) {
          if (i < jsub) {
            f0 *= Wt[i * HD + c0];
            f1 *= Wt[i * HD + c1];
          }
        }
        const float a[4] = {Qs[(ym0 + g) * QSTR + c0] * f0,
                            Qs[(ym0 + g + 8) * QSTR + c0] * f0,
                            Qs[(ym0 + g) * QSTR + c1] * f1,
                            Qs[(ym0 + g + 8) * QSTR + c1] * f1};
        uint32_t ab[4], as[4];
        split4(a, ab, as);
#pragma unroll
        for (int i = 0; i < P::TPW_Y; ++i) {
          const int nc = yn0 + 8 * i + g;
          uint32_t bb0, bb1, bs0, bs1;
          split(Ss[c0 * SSTR + nc], bb0, bs0);
          split(Ss[c1 * SSTR + nc], bb1, bs1);
          mma3(pb[h2][i], ps[h2][i], ab, as, bb0, bb1, bs0, bs1);
        }
      }
#pragma unroll
      for (int i = 0; i < P::TPW_Y; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = pb[0][i][e] + pb[1][i][e];
          acs[i][e] = ps[0][i][e] + ps[1][i][e];
        }
    }
    // (2c) Score blocks on the tensor cores, one 16 x 8 tile per job:
    // (query sub-chunk j, key sub-chunk i < j) as (Qs ⊙ D_ij) Ks^T, D_ij
    // the sub-chunks strictly between; when fast also i = j, as Qs (Ks ⊙
    // 1 / W_i)^T, kept below the diagonal, the bonus on it, 0 above.
    const int diag = fast;
    for (int job = warp; job < NSUB * (NSUB - 1 + 2 * diag); job += P::NW) {
      int pair = job / 2, j = 1 - diag;
      while (pair >= j + diag) { pair -= j + diag; ++j; }
      const int i = pair, kn0 = i * L + (job % 2) * 8;
      float d4[2][4] = {}, s4[2][4] = {};      // even, odd k-steps
#pragma unroll
      for (int kc = 0; kc < HD; kc += 8) {
        const int c0 = kc + tq, c1 = c0 + 4, h2 = kc / 8 % 2;
        float f0 = 1.f, f1 = 1.f, e0 = 1.f, e1 = 1.f;
        if (i == j) {
          e0 = __frcp_rn(Wt[i * HD + c0]);
          e1 = __frcp_rn(Wt[i * HD + c1]);
        }
#pragma unroll
        for (int m = 1; m < NSUB - 1; ++m) {
          if (m > i && m < j) {
            f0 *= Wt[m * HD + c0];
            f1 *= Wt[m * HD + c1];
          }
        }
        const float a[4] = {Qs[(j * L + g) * QSTR + c0] * f0,
                            Qs[(j * L + g + 8) * QSTR + c0] * f0,
                            Qs[(j * L + g) * QSTR + c1] * f1,
                            Qs[(j * L + g + 8) * QSTR + c1] * f1};
        uint32_t ab[4], as[4], bb0, bb1, bs0, bs1;
        split4(a, ab, as);
        split(Ks[(kn0 + g) * QSTR + c0] * e0, bb0, bs0);
        split(Ks[(kn0 + g) * QSTR + c1] * e1, bb1, bs1);
        mma3(d4[h2], s4[h2], ab, as, bb0, bb1, bs0, bs1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d4[0][e] = (d4[0][e] + d4[1][e]) + (s4[0][e] + s4[1][e]);
      float* dst = Am + (j * L + g) * ASTR + kn0 + 2 * tq;
      if (i < j) {
        dst[0] = d4[0][0]; dst[1] = d4[0][1];
        dst[8 * ASTR] = d4[0][2]; dst[8 * ASTR + 1] = d4[0][3];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = g + 8 * (e / 2), s = kn0 - i * L + 2 * tq + e % 2;
          dst[8 * ASTR * (e / 2) + e % 2] =
              s < t ? d4[0][e] : s == t ? Ud[j * L + t] : 0.f;
        }
      }
    }
    __syncthreads();

    // (3a) y += A v over keys up to this row tile's end; store rows < S.
#pragma unroll 2
    for (int kc = 0; kc < ym0 + 16; kc += 8) {
      const float a[4] = {Am[(ym0 + g) * ASTR + kc + tq],
                          Am[(ym0 + g + 8) * ASTR + kc + tq],
                          Am[(ym0 + g) * ASTR + kc + tq + 4],
                          Am[(ym0 + g + 8) * ASTR + kc + tq + 4]};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
#pragma unroll
      for (int i = 0; i < P::TPW_Y; ++i) {
        const int nc = yn0 + 8 * i + g;
        uint32_t bb0, bb1, bs0 = 0, bs1 = 0;
        split<BF16>(ld1(vs + (kc + tq) * VSTR + nc), bb0, bs0);
        split<BF16>(ld1(vs + (kc + tq + 4) * VSTR + nc), bb1, bs1);
        mma3<BF16>(acc[i], acs[i], ab, as, bb0, bb1, bs0, bs1);
      }
    }
    {
      T* yp = y + base + (size_t)(n * C + ym0 + g) * row_step + yn0 + 2 * tq;
#pragma unroll
      for (int i = 0; i < P::TPW_Y; ++i) {
        if (ym0 + g < steps)
          store2(yp + 8 * i, acc[i][0] + acs[i][0], acc[i][1] + acs[i][1]);
        if (ym0 + g + 8 < steps)
          store2(yp + 8 * row_step + 8 * i, acc[i][2] + acs[i][2],
                 acc[i][3] + acs[i][3]);
      }
    }

    // (3b) S = diag(Π w) S + (Ks ⊙ Π_{m>e_i} w_m)^T v: the product summed
    // from zero per tile, then added in IEEE f32.
    {
      float sfx[NSUB][2], dec[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = sm0 + g + 8 * e;
        float f = 1.f;
#pragma unroll
        for (int i = NSUB - 1; i >= 0; --i) {
          sfx[i][e] = f;
          f *= Wt[i * HD + ch];
        }
        dec[e] = f;
      }
      uint32_t kb[C / 8][4], ksm[C / 8][4];
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {
        const int sub = q * 8 / L, s0r = q * 8 + tq;
        const float a[4] = {Ks[s0r * QSTR + sm0 + g] * sfx[sub][0],
                            Ks[s0r * QSTR + sm0 + g + 8] * sfx[sub][1],
                            Ks[(s0r + 4) * QSTR + sm0 + g] * sfx[sub][0],
                            Ks[(s0r + 4) * QSTR + sm0 + g + 8] * sfx[sub][1]};
        split4(a, kb[q], ksm[q]);
      }
      // The warp's tiles innermost: TPW_S independent chains of products,
      // the small terms in accumulators of their own where registers allow.
      constexpr bool SEP = P::TPW_S <= 4;
      float part[P::TPW_S][4], pasm[SEP ? P::TPW_S : 1][4];
#pragma unroll
      for (int i = 0; i < P::TPW_S; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = pasm[SEP ? i : 0][e] = 0.f;
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {
#pragma unroll
        for (int i = 0; i < P::TPW_S; ++i) {
          const int nc = sn0 + 8 * i + g;
          uint32_t bb0, bb1, bs0 = 0, bs1 = 0;
          split<BF16>(ld1(vs + (q * 8 + tq) * VSTR + nc), bb0, bs0);
          split<BF16>(ld1(vs + (q * 8 + tq + 4) * VSTR + nc), bb1, bs1);
          mma3<BF16>(part[i], SEP ? pasm[SEP ? i : 0] : part[i], kb[q],
                     ksm[q], bb0, bb1, bs0, bs1);
        }
      }
#pragma unroll
      for (int i = 0; i < P::TPW_S; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[i][e] = fmaf(st[i][e], dec[e / 2],
                          SEP ? part[i][e] + pasm[SEP ? i : 0][e] : part[i][e]);
        const int n2 = sn0 + 8 * i + 2 * tq;
        store2(Ss + (sm0 + g) * SSTR + n2, st[i][0], st[i][1]);
        store2(Ss + (sm0 + g + 8) * SSTR + n2, st[i][2], st[i][3]);
      }
    }
  }

  float* sop = s_out + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < P::TPW_S; ++i) {
    const int n2 = sn0 + 8 * i + 2 * tq;
    store2(sop + (size_t)(sm0 + g) * HD + n2, st[i][0], st[i][1]);
    store2(sop + (size_t)(sm0 + g + 8) * HD + n2, st[i][2], st[i][3]);
  }
}

// Dynamic shared memory past 48 KB, and the whole carveout for shared
// memory, so that two CTAs share an SM wherever they fit.
template <typename T, int HD, bool SAVE_S = false>
cudaError_t set_attributes() {
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, HD, SAVE_S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<T, HD>::SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(wkv_kernel<T, HD, SAVE_S>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int HD, bool SAVE_S>
cudaError_t launch_as(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0, void* y,
                      void* s_out, void* s_chunks, int B, int S, int H,
                      cudaStream_t st) {
  using P = Cfg<T, HD>;
  const cudaError_t err = set_attributes<T, HD, SAVE_S>();
  if (err != cudaSuccess) return err;
  wkv_kernel<T, HD, SAVE_S><<<B * H, P::NT, P::SMEM, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out),
      static_cast<float*>(s_chunks), S, H);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, void* s_chunks, int B, int S, int H,
                   cudaStream_t st) {
  return s_chunks != nullptr
             ? launch_as<T, HD, true>(r, k, v, w, u, s0, y, s_out, s_chunks,
                                      B, S, H, st)
             : launch_as<T, HD, false>(r, k, v, w, u, s0, y, s_out, s_chunks,
                                       B, S, H, st);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_out, void* s_chunks, int B, int S,
                        int H, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, s_out, s_chunks, B, S,
                                  H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, s_out, s_chunks, B, S,
                                  H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, s_out, s_chunks, B, S,
                                  H, st);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, y, s_out, s_chunks, B,
                                    S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y: (B,S,H,hd) contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); w: (B,S,H,hd) float32; u: (H,hd) float32; s0, s_out:
// (B,H,hd,hd) float32; s_chunks (nullable): (B,H,ceil(S/C),hd,hd) float32,
// C = wkv_chunk_steps(hd); all 16-byte aligned.  Launches on `stream`;
// returns the launch's CUDA error code (0 on success).
extern "C" int wkv_fwd_save(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, void* s_chunks, int B,
                            int S, int H, int hd, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch_hd<float>(hd, r, k, v, w, u, s0, y, s_out, s_chunks, B,
                               S, H, st)
          : dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, s_out,
                                       s_chunks, B, S, H, st);
  return (int)err;
}

// The inference forward: wkv_fwd_save without the chunk states.
extern "C" int wkv_fwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* y,
                       void* s_out, int B, int S, int H, int hd, int dtype,
                       void* stream) {
  return wkv_fwd_save(r, k, v, w, u, s0, y, s_out, nullptr, B, S, H, hd,
                      dtype, stream);
}

// Steps of a chunk at head dim hd (0 if the kernel does not take hd): the
// chunk states' stride in time.
extern "C" int wkv_chunk_steps(int hd) {
  switch (hd) {
    case 16: return Cfg<float, 16>::C;
    case 32: return Cfg<float, 32>::C;
    case 64: return Cfg<float, 64>::C;
    case 128: return Cfg<float, 128>::C;
    default: return 0;
  }
}
