// Newton–Schulz orthogonalization (Muon) for Hopper (sm_90a), CUDA C++ on
// the tensor cores in error-compensated TF32 ("3xTF32").
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
//       2. per iteration, three products of one batched GEMM with a fused
//          epilogue  out = alpha * A * op(B) + beta * D:
//            G = X * X^T        (symmetric: upper tiles only, mirrored)
//            P = c * G * G + b * G
//                               (G is exactly symmetric, so G * G is taken
//                                as G * G^T: symmetric too, both operands
//                                k-contiguous)
//            X' = P * X + a * X (ping-pong buffers: X is read while X' is
//                                written)
//   * matmul (the tiled (M,K)@(K,N) with an f32 accumulator that the
//     reference composes for matrices too large to fuse): the same GEMM's
//     unbatched entry point, with a flag for a transposed right operand so
//     x @ x.T never materializes x.T, and the epilogue's beta * D for the
//     large route's elementwise updates.
//
// Precision.  Inputs f32 or bf16, widened to f32 on load; the output is
// rounded once to its type.  Every product runs on the tensor cores
// (wgmma, TF32 in, f32 accumulator) in 3xTF32: each f32 operand value x is
// split into big = tf32(x) and small = tf32(x - big) (round to nearest,
// ties away), and the accumulator takes small_a * big_b + big_a * small_b
// + big_a * big_b; small * small (~2^-22 relative) is dropped.  Plain TF32
// (one product) keeps ~10 bits and puts five quintic steps ~5e-3 off the
// f32 chain; 3xTF32 stays ~1e-5 off (the CPU emulation in
// tests/test_torch_newton_schulz.py).  The tensor cores truncate as they
// accumulate, which over thousands of steps biases a long same-signed sum
// (a Gram's diagonal) by ~1e-4; so each 32-deep k-slice is summed afresh
// and added to the running sum in IEEE f32.  bf16 inputs are exact in TF32,
// so a bf16 GEMM takes the one product.
//
// What bounds a launch on this card (H100 SXM: 495 TFLOP/s TF32 on the
// tensor cores, so 165 TFLOP/s of f32-accurate 3xTF32 products, against
// 67 TFLOP/s of f32 FMA outside them; 3.35 TB/s): one quintic iteration on
// an n x m matrix (n <= m) is 2n^2 m (X X^T, half of it needed) + 2n^3
// (G G, half needed) + 2n^2 m (P X) FLOP against ~3nm + 3n^2 floats, so
// every launch at the GPT-2 shapes (n = 768) is bound by operations, ~100x
// over its bytes.  What the design does about it:
//
//   * tensor cores through wgmma: the kernel computes C' = A' B'^T with
//     both operands k-contiguous in shared memory, as TF32 wgmma needs.  A
//     product with B n-contiguous (P X) runs as C^T = B^T A^T: A' = B^T is
//     read m-contiguous into registers (wgmma takes A from registers in
//     any layout the kernel loads), B' = A, and the epilogue writes C'
//     transposed.  128x128 output tiles, two warpgroups of 64 rows, each
//     warpgroup 4 k8 steps x 3 products of m64n128k8 per 32-deep k-slice;
//     A' fragments are split in registers, B' once per block into big and
//     small copies in wgmma's core-matrix layout;
//   * a ring of STAGES = 4 raw k-slices in dynamic shared memory (170-184
//     KB a block with the split copies: one block per SM), filled with
//     16-byte cp.async (zero-fill at the ragged edges; 4-byte copies where
//     a row is not 16-byte aligned, plain loads for bf16), so three slices
//     are in flight while one is split and multiplied.  Rows are
//     padded so that the fragment and split loads are conflict-free;
//   * symmetric products (X X^T, G G^T) launch only the tiles with
//     tile-row <= tile-column and write each tile and its mirror through a
//     shared-memory copy of the tile (rows and columns conflict-free, 129
//     apart), so both writes are coalesced and the result is exactly
//     symmetric (a diagonal tile writes its upper triangle twice, never its
//     lower one); D must then be symmetric too, as it is (D = G);
//   * split-K where the output grid has fewer blocks than about two waves
//     (the tied embedding's 768x50304 Gram has 21 upper tiles for 132 SMs):
//     the caller's plan (ops.gemm_plan) cuts K into `splits` slices of
//     k_split; each block writes its f32 partial tile to the caller's
//     workspace, and a second launch sums the partials in a fixed order
//     (no atomics: the same inputs give the same bits on every run),
//     applies the epilogue and writes C (and its mirror);
//   * ragged M, N and K are masked on load and on store; nothing relies on
//     the caller padding to the TPU's 128.  The batch index is blockIdx.z
//     with per-operand batch strides.
//
// What binds it now: per slice the block waits for its copies, splits B',
// runs its wgmma and waits for them, one phase after the other (one block
// of 170 registers a thread per SM), and the 128x128 tiles load ~32 flop
// per byte from L2.  Warp specialisation (a producer that loads and splits
// while the consumers multiply), TMA with multicast across a cluster, and
// larger tiles are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;            // rows of C' per block: two warpgroups of 64
constexpr int BN = 128;            // columns of C' per block: one m64n128k8
constexpr int BK = 32;
constexpr int STAGES = 4;          // k-slices in the shared-memory ring
constexpr int GEMM_THREADS = 256;
constexpr int KA_LD = BK + 8;      // A' k-contiguous rows: 8-byte loads, banks 8g + 2t
constexpr int MA_LD = BM + 4;      // A' m-contiguous rows: banks 8t + g
constexpr int KB_LD = BK + 4;      // B' rows: 16-byte loads, banks 4n
constexpr int SPLIT = BN * BK;     // floats of B' big (or small) per k-slice
constexpr int T_LD = BN + 1;       // the epilogue's tile: rows and columns
constexpr int RED_ROWS = 32;       // rows of a tile per reduction block

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

// Floats of one ring stage: A' (k- or m-contiguous) then B'.
__host__ __device__ constexpr int stage_floats(bool a_kmajor) {
  return (a_kmajor ? BM * KA_LD : BK * MA_LD) + BN * KB_LD;
}

// One GEMM launch as the kernel sees it: C' = alpha * A' B'^T + beta * D,
// batched over blockIdx.z.  B' (N', K) is k-contiguous (row stride ldb);
// A' (M', K) is k-contiguous (row stride lda) or, for a kernel built with
// A_KMAJOR false, stored m-contiguous as (K, M') with row stride lda.  C'
// lands in C (M' x N', row stride ldc), or transposed (trans_out: C is
// N' x M') - so C = A B with B (K, N) n-contiguous runs as C^T = B^T A^T.
// D (may be null) is read where C is written.  sym: C' is symmetric
// (M' == N') and so is D.  splits > 1: partial tiles go to ws, (batch,
// splits, tiles, BM*BN) floats.
struct Gemm {
  const void* A;
  const void* B;
  const void* D;
  void* C;
  float* ws;
  int M, N, K;
  long long lda, ldb, ldd, ldc, sa, sb, sd, sc;
  float alpha, beta;
  int tiles_m, tiles_n, n_fast, sym, trans_out, splits, k_split;
};

// Output tile (tm, tn) of launch index t: row-major over the upper triangle
// when symmetric, else the shorter side fastest, so that the blocks which
// share the long operand's strip run together.
__device__ __forceinline__ void tile_coords(const Gemm& g, int t, int& tm,
                                            int& tn) {
  if (g.sym) {
    int i = 0, row = g.tiles_m;
    while (t >= row) {
      t -= row;
      --row;
      ++i;
    }
    tm = i;
    tn = i + t;
  } else if (g.n_fast) {
    tn = t % g.tiles_n;
    tm = t / g.tiles_n;
  } else {
    tm = t % g.tiles_m;
    tn = t / g.tiles_m;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copies of `bytes` (0 .. the size) from global memory, the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = big + small + O(2^-22 |x|): big = tf32(x), small = tf32(x - big),
// each rounded to nearest with ties away from zero (cvt.rna.tf32.f32 for
// finite x: half an ulp of TF32 added to the sign-magnitude bits, the 13
// low bits then dropped).  Written with integer ops, 4 instructions an
// element where the cvt's SASS takes 7 (it tests for Inf/NaN); a NaN may
// come out as an Inf.  The tensor cores ignore the 13 low bits of a TF32
// operand, so only big, which the subtraction needs exactly, is masked.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// Shared-memory matrix descriptor of a k-contiguous operand without
// swizzle: 8-row core matrices of 16 bytes a row stored contiguously (128
// bytes), `lbo` bytes between the two core matrices of a k8 step, `sbo`
// bytes between neighbouring 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

#define NS_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b^T over one 64x128x8 step of a warpgroup: a from registers (the
// m16n8k8 A fragment of each warp's 16 rows), b (128 x 8) through its
// descriptor; accumulate (d +=) unless scale_d is 0 (d =).
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      "{%64,%65,%66,%67}, %69, p, 1, 1;\n}\n"
      : NS_D8(0), NS_D8(8), NS_D8(16), NS_D8(24), NS_D8(32), NS_D8(40),
        NS_D8(48), NS_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}
#undef NS_D8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Writes rows r0 .. r0+ROWS-1 of output tile (m0, n0) of C' from `tile`
// (ROWS x T_LD floats in shared memory, the raw sums): alpha * sum +
// beta * D, masked to M' x N'.  C'[r][c] goes to C[r][c] unless trans_out,
// and with sym also to its mirror C[c][r]; the transposed writes read the
// tile column by column so that they are coalesced too.  A diagonal tile
// of a symmetric product writes its upper triangle (r <= c) and that
// triangle's mirror only, so C comes out exactly symmetric.
template <typename T, int ROWS>
__device__ void store_rows(const Gemm& g, const float* tile, int z, int m0,
                           int n0, int r0) {
  T* C = static_cast<T*>(g.C) + z * g.sc;
  const T* D = g.D ? static_cast<const T*>(g.D) + z * g.sd : nullptr;
  const bool diag = g.sym && m0 == n0;
  if (!g.trans_out) {
    for (int i = threadIdx.x; i < ROWS * BN; i += GEMM_THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = m0 + r0 + r, gc = n0 + c;
      if (gr >= g.M || gc >= g.N || (diag && r0 + r > c)) continue;
      float v = g.alpha * tile[r * T_LD + c];
      if (D != nullptr) v = fmaf(g.beta, to_f32(D[gr * g.ldd + gc]), v);
      store_f32(&C[gr * g.ldc + gc], v);
    }
  }
  if (!g.sym && !g.trans_out) return;
  for (int i = threadIdx.x; i < ROWS * BN; i += GEMM_THREADS) {
    const int c = i / ROWS, r = i % ROWS;
    const int gr = m0 + r0 + r, gc = n0 + c;
    if (gr >= g.M || gc >= g.N || (diag && r0 + r >= c)) continue;
    float v = g.alpha * tile[r * T_LD + c];
    // Transposed, D is read where C is written; mirrored, D is symmetric.
    if (D != nullptr) v = fmaf(g.beta, to_f32(D[gc * g.ldd + gr]), v);
    store_f32(&C[gc * g.ldc + gr], v);
  }
}

// VEC: f32 operands whose rows and bases are 16-byte aligned (16-byte
// cp.async); otherwise 4-byte cp.async (f32) or plain loads (bf16).
//
// Shared memory: B' big and small (the split of the current k-slice, in
// wgmma's core-matrix layout), then the ring of raw f32 k-slices.  Per
// slice: wait for it, start the load STAGES - 1 slices ahead, split B'
// into big/small (every element once), load each warp's A' fragments and
// split them in registers, then 12 wgmma per warpgroup (4 k8 steps x 3
// products) into `part`, which is added to `acc` once the slice is done.
template <typename T, bool A_KMAJOR, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_kernel(const Gemm g) {
  extern __shared__ __align__(128) float smem[];
  constexpr int SA = A_KMAJOR ? BM * KA_LD : BK * MA_LD;
  constexpr int SF = SA + BN * KB_LD;
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  float* big = smem;
  float* small = smem + SPLIT;
  float* ring = smem + 2 * SPLIT;
  const int z = blockIdx.z;
  const int split = blockIdx.y;
  int tm, tn;
  tile_coords(g, blockIdx.x, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const T* A = static_cast<const T*>(g.A) + z * g.sa;
  const T* B = static_cast<const T*>(g.B) + z * g.sb;
  const int kb = split * g.k_split;
  const int ke = min(g.K, kb + g.k_split);
  const int nk = (ke - kb + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // This thread's fragment row of the tile: warp w holds rows 16w .. 16w+15
  // (warpgroup w / 4 the 64 rows from 64 (w / 4)).
  const int row = (tid >> 5) * 16 + (lane >> 2);
  const int tq = lane & 3;

  // Stage st <- k-slice [k0, k0 + BK) of A' and B'; zero outside M', N' and
  // [kb, ke).
  auto load_stage = [&](int st, int k0) {
    float* As = ring + st * SF;
    float* Bs = As + SA;
    if constexpr (VEC) {
      const float* Af = reinterpret_cast<const float*>(A);
      const float* Bf = reinterpret_cast<const float*>(B);
      if constexpr (A_KMAJOR) {
#pragma unroll
        for (int i = 0; i < BM * BK / 4 / GEMM_THREADS; ++i) {
          const int q = tid + i * GEMM_THREADS;
          const int r = q >> 3, kc = (q & 7) * 4;
          const int gr = m0 + r, gk = k0 + kc;
          const int bytes = gr < g.M ? max(0, min(16, (ke - gk) * 4)) : 0;
          cp_async16(As + r * KA_LD + kc,
                     bytes ? Af + gr * g.lda + gk : Af, bytes);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK * BM / 4 / GEMM_THREADS; ++i) {
          const int q = tid + i * GEMM_THREADS;
          const int r = q >> 5, mc = (q & 31) * 4;
          const int gk = k0 + r, gm = m0 + mc;
          const int bytes = gk < ke ? max(0, min(16, (g.M - gm) * 4)) : 0;
          cp_async16(As + r * MA_LD + mc,
                     bytes ? Af + gk * g.lda + gm : Af, bytes);
        }
      }
#pragma unroll
      for (int i = 0; i < BN * BK / 4 / GEMM_THREADS; ++i) {
        const int q = tid + i * GEMM_THREADS;
        const int r = q >> 3, kc = (q & 7) * 4;
        const int gn = n0 + r, gk = k0 + kc;
        const int bytes = gn < g.N ? max(0, min(16, (ke - gk) * 4)) : 0;
        cp_async16(Bs + r * KB_LD + kc,
                   bytes ? Bf + gn * g.ldb + gk : Bf, bytes);
      }
    } else {
      // One element a copy: 16 per thread per operand.
      auto put = [&](float* dst, const T* base, long long off, bool ok) {
        if constexpr (std::is_same<T, float>::value) {
          cp_async4(dst, ok ? base + off : base, ok ? 4 : 0);
        } else {
          *dst = ok ? to_f32(base[off]) : 0.f;
        }
      };
#pragma unroll 4
      for (int i = 0; i < BM * BK / GEMM_THREADS; ++i) {
        const int q = tid + i * GEMM_THREADS;
        if constexpr (A_KMAJOR) {
          const int r = q >> 5, k = q & 31;
          const int gr = m0 + r, gk = k0 + k;
          put(As + r * KA_LD + k, A, gr * g.lda + gk, gr < g.M && gk < ke);
        } else {
          const int r = q >> 7, m = q & 127;
          const int gk = k0 + r, gm = m0 + m;
          put(As + r * MA_LD + m, A, gk * g.lda + gm, gk < ke && gm < g.M);
        }
      }
#pragma unroll 4
      for (int i = 0; i < BN * BK / GEMM_THREADS; ++i) {
        const int q = tid + i * GEMM_THREADS;
        const int r = q >> 5, k = q & 31;
        const int gn = n0 + r, gk = k0 + k;
        put(Bs + r * KB_LD + k, B, gn * g.ldb + gk, gn < g.N && gk < ke);
      }
    }
  };

  // acc: the sum over the slices done, in IEEE f32 adds; part: this
  // slice's sum on the tensor cores (see the note at the top).  Warpgroup
  // wg holds rows 64 wg .. 64 wg + 63 of the tile, in wgmma's accumulator
  // layout: part[4j + e] is row `row` (+8 for e >= 2) of the warpgroup,
  // column 8j + 2tq (+1 for odd e).
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kb + s * BK);
    cp_async_commit();
  }
  int rd = 0, wr = STAGES - 1;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();       // slice t has landed (this thread's)
    __syncthreads();                   // ... everyone's; slice t-1, big and
                                       // small are free
    if (t + STAGES - 1 < nk) load_stage(wr, kb + (t + STAGES - 1) * BK);
    cp_async_commit();
    wr = wr + 1 == STAGES ? 0 : wr + 1;
    const float* As = ring + rd * SF;
    const float* Bs = As + SA;
    rd = rd + 1 == STAGES ? 0 : rd + 1;

    // B' -> big, small.  Within each k8 step the k order is permuted alike
    // for A' and B' (slot j <- k 2j, slot j + 4 <- k 2j + 1; a sum does not
    // depend on it), so that a thread's two A' values of a row are adjacent.
    // Core matrix (step s, half h, rows 8q..8q+7) at ((2s + h) 16 + q) 32.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = tid & 127, s = (tid >> 7) + 2 * u;
      const float4 lo = *reinterpret_cast<const float4*>(Bs + n * KB_LD + 8 * s);
      const float4 hi =
          *reinterpret_cast<const float4*>(Bs + n * KB_LD + 8 * s + 4);
      const float even[4] = {lo.x, lo.z, hi.x, hi.z};
      const float odd[4] = {lo.y, lo.w, hi.y, hi.w};
      const int off = ((2 * s) * 16 + (n >> 3)) * 32 + (n & 7) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* v = h ? odd : even;
        uint32_t b4[4], s4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (EXACT) b4[e] = __float_as_uint(v[e]);
          else split_tf32(v[e], b4[e], s4[e]);
        }
        *reinterpret_cast<uint4*>(big + off + h * 16 * 32) =
            make_uint4(b4[0], b4[1], b4[2], b4[3]);
        if constexpr (!EXACT)
          *reinterpret_cast<uint4*>(small + off + h * 16 * 32) =
              make_uint4(s4[0], s4[1], s4[2], s4[3]);
      }
    }
    // The generic-proxy writes above are read by wgmma (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // A' fragments: warpgroup rows `row` and `row` + 8 of step s, slots tq
    // and tq + 4 (k 8s + 2tq and 8s + 2tq + 1).
    uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float v[4];
      if constexpr (A_KMAJOR) {
        const float* p = As + row * KA_LD + 8 * s + 2 * tq;
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8 * KA_LD);
        v[0] = lo.x; v[1] = hi.x; v[2] = lo.y; v[3] = hi.y;
      } else {
        const float* p = As + (8 * s + 2 * tq) * MA_LD + row;
        v[0] = p[0]; v[1] = p[8]; v[2] = p[MA_LD]; v[3] = p[MA_LD + 8];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (EXACT) a_big[s][e] = __float_as_uint(v[e]);
        else split_tf32(v[e], a_big[s][e], a_small[s][e]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t db = smem_desc(big + s * 2 * 16 * 32, 16 * 32 * 4, 32 * 4);
      if constexpr (!EXACT) {
        const uint64_t ds =
            smem_desc(small + s * 2 * 16 * 32, 16 * 32 * 4, 32 * 4);
        wgmma_tf32(part, a_small[s], db, s);
        wgmma_tf32(part, a_big[s], ds, 1);
        wgmma_tf32(part, a_big[s], db, 1);
      } else {
        wgmma_tf32(part, a_big[s], db, s);
      }
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // acc[4j + e]: tile row `row` (+8 for e >= 2), column 8j + 2tq (+1 for
  // odd e).
  const int r = row;
  if (g.splits > 1) {
    float* w = g.ws + (((long long)z * g.splits + split) * gridDim.x +
                       blockIdx.x) * (BM * BN);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(w + r * BN + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(w + (r + 8) * BN + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }
  __syncthreads();                     // the ring is free: reuse it
  float* tile = smem;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * tq;
    tile[r * T_LD + c] = acc[4 * j];
    tile[r * T_LD + c + 1] = acc[4 * j + 1];
    tile[(r + 8) * T_LD + c] = acc[4 * j + 2];
    tile[(r + 8) * T_LD + c + 1] = acc[4 * j + 3];
  }
  __syncthreads();
  store_rows<T, BM>(g, tile, z, m0, n0, 0);
}

// The split-K partials of one tile's rows r0 .. r0+RED_ROWS-1, summed over
// the splits in order 0, 1, ..., then the epilogue.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
splitk_reduce(const Gemm g) {
  __shared__ float tile[RED_ROWS * T_LD];
  const int z = blockIdx.z, r0 = blockIdx.y * RED_ROWS;
  int tm, tn;
  tile_coords(g, blockIdx.x, tm, tn);
  if (tm * BM + r0 >= g.M) return;
  const long long per_tile = BM * BN;
  const long long split_stride = (long long)gridDim.x * per_tile;
  const float* w = g.ws + ((long long)z * g.splits * gridDim.x + blockIdx.x) *
                              per_tile + r0 * BN;
  for (int i = threadIdx.x; i < RED_ROWS * BN; i += GEMM_THREADS) {
    float s = 0.f;
    for (int p = 0; p < g.splits; ++p) s += w[p * split_stride + i];
    tile[(i / BN) * T_LD + i % BN] = s;
  }
  __syncthreads();
  store_rows<T, RED_ROWS>(g, tile, z, tm * BM, tn * BN, r0);
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

int gemm_smem_bytes(bool a_kmajor) {
  const int ring = 2 * SPLIT + STAGES * stage_floats(a_kmajor);
  return (int)sizeof(float) * (ring > BM * T_LD ? ring : BM * T_LD);
}

int tiles_of(const Gemm& g) {
  return g.sym ? g.tiles_m * (g.tiles_m + 1) / 2 : g.tiles_m * g.tiles_n;
}

// The GEMM (and, with splits > 1, its reduction) on the stream.  A launch
// refused for its shared memory returns the error and leaves none behind.
template <typename T, bool A_KMAJOR, bool VEC>
cudaError_t launch(const Gemm& g, int batch, cudaStream_t stream) {
  const int smem = gemm_smem_bytes(A_KMAJOR);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T, A_KMAJOR, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const int tiles = tiles_of(g);
  gemm_kernel<T, A_KMAJOR, VEC>
      <<<dim3(tiles, g.splits, batch), GEMM_THREADS, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  splitk_reduce<T><<<dim3(tiles, BM / RED_ROWS, batch), GEMM_THREADS, 0,
                     stream>>>(g);
  return cudaGetLastError();
}

bool aligned16(const void* p, long long ld, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 &&
         stride % 4 == 0;
}

// C = alpha * A op(B) + beta * D as the caller sees it (Gemm's fields in the
// caller's terms: A (M, K), B (N, K) with trans_b or (K, N), C (M, N)),
// launched as the kernel's C' = A' B'^T: with trans_b A' = A, B' = B; else
// A' = B (m-contiguous), B' = A and C' = C^T.
cudaError_t gemm(Gemm g, int batch, bool trans_b, int dtype,
                 cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || g.M <= 0 || g.N <= 0 || g.K <= 0 ||
      g.splits <= 0 || g.splits > 65535 || g.k_split <= 0 ||
      g.k_split % BK != 0 || (long long)(g.splits - 1) * g.k_split >= g.K ||
      (long long)g.splits * g.k_split < g.K ||
      (g.splits > 1 && g.ws == nullptr) ||
      (g.sym && (g.M != g.N || !trans_b)))
    return cudaErrorInvalidValue;
  if (!trans_b) {
    const void* a = g.A;
    const long long lda = g.lda, sa = g.sa;
    const int m = g.M;
    g.A = g.B;
    g.lda = g.ldb;
    g.sa = g.sb;
    g.B = a;
    g.ldb = lda;
    g.sb = sa;
    g.M = g.N;
    g.N = m;
    g.trans_out = 1;
  }
  g.tiles_m = (g.M + BM - 1) / BM;
  g.tiles_n = (g.N + BN - 1) / BN;
  g.n_fast = g.tiles_n < g.tiles_m;
  if (tiles_of(g) <= 0) return cudaErrorInvalidValue;
  if (dtype == 1)
    return trans_b ? launch<__nv_bfloat16, true, false>(g, batch, stream)
                   : launch<__nv_bfloat16, false, false>(g, batch, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const bool vec = aligned16(g.A, g.lda, g.sa) && aligned16(g.B, g.ldb, g.sb);
  if (trans_b)
    return vec ? launch<float, true, true>(g, batch, stream)
               : launch<float, true, false>(g, batch, stream);
  return vec ? launch<float, false, true>(g, batch, stream)
             : launch<float, false, false>(g, batch, stream);
}

Gemm make_gemm(const void* a, const void* b, const void* d, void* c,
               float* ws, int M, int N, int K, long long lda, long long ldb,
               long long ldd, long long ldc, long long sa, long long sb,
               long long sd, long long sc, float alpha, float beta, int sym,
               int splits, int k_split) {
  Gemm g = {};
  g.A = a;
  g.B = b;
  g.D = d;
  g.C = c;
  g.ws = ws;
  g.M = M;
  g.N = N;
  g.K = K;
  g.lda = lda;
  g.ldb = ldb;
  g.ldd = ldd;
  g.ldc = ldc;
  g.sa = sa;
  g.sb = sb;
  g.sd = sd;
  g.sc = sc;
  g.alpha = alpha;
  g.beta = beta;
  g.sym = sym;
  g.splits = splits;
  g.k_split = k_split;
  return g;
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

// C = alpha * A op(B) + beta * D.  dtype: 0 = float32, 1 = bfloat16 (A, B,
// D and C share it).  sym: C is symmetric (see Gemm).  (splits, k_split)
// and the workspace ws come from the caller's plan (ops.gemm_plan).
// Returns a cudaError_t (0 = launched).
extern "C" int ns_gemm(const void* a, const void* b, const void* d, void* c,
                       float* ws, int batch, int M, int N, int K,
                       long long lda, long long ldb, long long ldd,
                       long long ldc, long long sa, long long sb,
                       long long sd, long long sc, int trans_b, int sym,
                       int splits, int k_split, float alpha, float beta,
                       int dtype, void* stream) {
  const Gemm g = make_gemm(a, b, d, c, ws, M, N, K, lda, ldb, ldd, ldc, sa,
                           sb, sd, sc, alpha, beta, sym, splits, k_split);
  return (int)gemm(g, batch, trans_b != 0, dtype,
                   static_cast<cudaStream_t>(stream));
}

// The whole Newton–Schulz chain on x (L, n, m), n <= m, of type dtype:
// xa, xb (L, n, m) and g, p (L, n, n) are f32 work buffers, partial holds
// L * 32 floats, ws the largest split-K workspace of the three products'
// plans ((s_gram, k_gram) for X X^T, (s_gg, k_gg) for G G^T, (s_px, k_px)
// for P X; ops.ns_fused_plans).  After `steps` iterations the result is in
// xa when steps is even and in xb when it is odd.  (ca, cb, cc) are the
// quintic's coefficients.  Returns the first cudaError_t (0 = all
// launched).
extern "C" int ns_fused(const void* x, float* xa, float* xb, float* g,
                        float* p, float* partial, float* ws, int L, int n,
                        int m, int steps, float eps, float ca, float cb,
                        float cc, int s_gram, int k_gram, int s_gg, int k_gg,
                        int s_px, int k_px, int dtype, void* stream) {
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
    err = gemm(make_gemm(cur, cur, nullptr, g, ws, n, n, m, m, m, 0, n, per,
                         per, 0, nn, 1.f, 0.f, 1, s_gram, k_gram),
               L, true, 0, st);
    if (err != cudaSuccess) return (int)err;
    // P = c G G^T + b G
    err = gemm(make_gemm(g, g, g, p, ws, n, n, n, n, n, n, n, nn, nn, nn, nn,
                         cc, cb, 1, s_gg, k_gg),
               L, true, 0, st);
    if (err != cudaSuccess) return (int)err;
    // X' = P X + a X
    err = gemm(make_gemm(p, cur, cur, nxt, ws, n, m, n, n, m, m, m, nn, per,
                         per, per, 1.f, ca, 0, s_px, k_px),
               L, false, 0, st);
    if (err != cudaSuccess) return (int)err;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}
