// Shared by the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): the masking constant, cp.async staging of a
// head's rows into shared memory, the 3xTF32 split, the two operand layouts
// the tensor cores read, and the TF32 wgmma of one warpgroup.
//
// The pieces, in the order a tile meets them:
//
//   * raw tiles: rows of a (B, S, heads, HD) tensor copied by 16-byte
//     cp.async into shared memory as they lie (f32 or bf16), rows >= S
//     zero-filled; the 16-byte chunk c of row r sits at chunk c ^ (r & 7),
//     so that the split passes below read them without bank conflicts;
//   * slots: a 64-row operand that a warpgroup takes as A from registers
//     (Q, dO in the forward and dQ pass; K, V in the dK/dV pass), kept in
//     shared memory as raw f32 in wgmma's A-fragment order, one float4 per
//     thread and k8 step, and split into TF32 big/small as it is loaded;
//   * split passes: a raw tile rewritten as the B operand, TF32 big and
//     small copies in wgmma's core-matrix layout (8 rows x 16 bytes,
//     no swizzle).  K-major: B[n][k] = X[n][k] (K in S = Q K^T, Q in
//     S^T = K Q^T).  Transposed: B[n][k] = X[k][n] (V in O = P V, K in
//     dQ = dS K, Q and dO in dK = dS^T Q and dV = P^T dO);
//   * wgmma m64nNk8 TF32 (N = 8, 16, 32 or 64), A from registers, B through a
//     shared-memory descriptor, f32 accumulator.
//
// Within each k8 step the k order is permuted alike for A and B: slot j
// holds k = 2j and slot j + 4 holds k = 2j + 1 (a sum does not depend on
// it).  That makes a thread's two A values of a row adjacent in k, so the
// score accumulator of one product (row g, columns 2t, 2t + 1 of each
// 8-column block) is the A fragment of the next (P V, dS K, P^T dO, dS^T
// Q) with no exchange between threads.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
// exp(x) = 2^(x log2 e): the softmax runs in base 2 (one ex2 a score).
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory, read next by wgmma (async proxy).
__device__ __forceinline__ void fence_to_tensor_cores() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Raw tiles
// ---------------------------------------------------------------------------

// The copy and split loops below are unrolled whole at hd 64 (their loads
// then issue together) and by two at hd 128 and 256, where whole unrolling
// spills.

// Rows [row0, row0 + ROWS) of one head (row stride `stride` elements) into
// `dst` (ROWS x HD elements of T, chunks swizzled), by cp.async; rows >= S
// are zero.  One commit group is the caller's.
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void load_raw(T* dst, const T* base, int row0,
                                         int S, int stride) {
  constexpr int EPC = 16 / sizeof(T);          // elements per chunk
  constexpr int CPR = HD / EPC;                // chunks per row (>= 8)
  static_assert(ROWS * CPR % NT == 0, "load_raw: whole passes");
#pragma unroll (HD == 64 ? 16 : 2)
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < S;
    const T* src = ok ? base + (size_t)(row0 + r) * stride + c * EPC : base;
    cp_async16(dst + r * HD + ((c ^ (r & 7)) * EPC), src, ok ? 16 : 0);
  }
}

// Eight elements of raw row r from column c0 (a multiple of 8), as f32.
template <int HD>
__device__ __forceinline__ void read8(const float* raw, int r, int c0,
                                      float (&v)[8]) {
  const float* row = raw + r * HD;
  const float4 a = *reinterpret_cast<const float4*>(
      row + ((((c0 >> 2)) ^ (r & 7)) << 2));
  const float4 b = *reinterpret_cast<const float4*>(
      row + ((((c0 >> 2) + 1) ^ (r & 7)) << 2));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <int HD>
__device__ __forceinline__ void read8(const __nv_bfloat16* raw, int r, int c0,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(
      raw + r * HD + (((c0 >> 3) ^ (r & 7)) << 3));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {        // bf16 -> f32 is exact: the high bits
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <int HD>
__device__ __forceinline__ float read1(const float* raw, int r, int c) {
  return raw[r * HD + ((((c >> 2)) ^ (r & 7)) << 2) + (c & 3)];
}
template <int HD>
__device__ __forceinline__ float read1(const __nv_bfloat16* raw, int r,
                                       int c) {
  return __bfloat162float(raw[r * HD + (((c >> 3) ^ (r & 7)) << 3) + (c & 7)]);
}

// ---------------------------------------------------------------------------
// The 3xTF32 split
// ---------------------------------------------------------------------------

// x = big + small + O(2^-22 |x|): big = tf32(x), small = tf32(x - big),
// each rounded to nearest with ties away from zero (cvt.rna.tf32.f32 for
// finite x, written with integer ops as in newton_schulz.cu).  The tensor
// cores ignore the 13 low bits of a TF32 operand, so only big, which the
// subtraction needs exactly, is masked.  EXACT (bf16 inputs, which TF32
// holds exactly, or a value whose product needs one pass): big = tf32(x)
// and no small.
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  if constexpr (!EXACT)
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// Writes one 4-slot row of a core matrix: big (and small) copies at `off`.
template <bool EXACT>
__device__ __forceinline__ void put4(uint32_t* big, uint32_t* small, int off,
                                     float a, float b, float c, float d) {
  uint32_t bb[4], ss[4];
  split_tf32<EXACT>(a, bb[0], ss[0]);
  split_tf32<EXACT>(b, bb[1], ss[1]);
  split_tf32<EXACT>(c, bb[2], ss[2]);
  split_tf32<EXACT>(d, bb[3], ss[3]);
  *reinterpret_cast<uint4*>(big + off) = make_uint4(bb[0], bb[1], bb[2], bb[3]);
  if constexpr (!EXACT)
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(ss[0], ss[1], ss[2], ss[3]);
}

// K-major B of NR rows: B[n][k] = raw[n][k], k over HD.  Core matrix
// (step s, half h, rows 8q..8q+7) at ((2s + h) NR/8 + q) 32 words; half 0
// holds k = 8s + {0, 2, 4, 6}, half 1 k = 8s + {1, 3, 5, 7}.
template <typename T, int HD, int NR, int NT, bool EXACT>
__device__ __forceinline__ void split_kmajor(uint32_t* big, uint32_t* small,
                                             const T* raw) {
  static_assert(NR * (HD / 8) % NT == 0, "split_kmajor: whole passes");
#pragma unroll (HD == 64 ? 16 : 2)
  for (int it = 0; it < NR * (HD / 8) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int n = i % NR, s = i / NR;
    float v[8];
    read8<HD>(raw, n, 8 * s, v);
    const int off = ((2 * s) * (NR / 8) + (n >> 3)) * 32 + (n & 7) * 4;
    put4<EXACT>(big, small, off, v[0], v[2], v[4], v[6]);
    put4<EXACT>(big, small, off + (NR / 8) * 32, v[1], v[3], v[5], v[7]);
  }
}

// Transposed B of HD columns: B[n][k] = raw[k][n], k over the NK raw rows.
// Core matrix (step s, half h, columns 8q..8q+7) at ((2s + h) HD/8 + q) 32
// words, the k order of each step permuted as above.
template <typename T, int HD, int NK, int NT, bool EXACT>
__device__ __forceinline__ void split_trans(uint32_t* big, uint32_t* small,
                                            const T* raw) {
  static_assert(HD * (NK / 8) % NT == 0, "split_trans: whole passes");
#pragma unroll (HD == 64 ? 16 : 2)
  for (int it = 0; it < HD * (NK / 8) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int n = i % HD, s = i / HD;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = read1<HD>(raw, 8 * s + j, n);
    const int off = ((2 * s) * (HD / 8) + (n >> 3)) * 32 + (n & 7) * 4;
    put4<EXACT>(big, small, off, v[0], v[2], v[4], v[6]);
    put4<EXACT>(big, small, off + (HD / 8) * 32, v[1], v[3], v[5], v[7]);
  }
}

// ---------------------------------------------------------------------------
// Slots: a warpgroup's 64-row A operand in fragment order
// ---------------------------------------------------------------------------

// Rows row0 + 16w + g and + 8 (w the warp in its warpgroup, g = lane / 4)
// of one head into slot (s 4 + w) 32 + lane for every k8 step s: the f32
// values at k = 8s + 2t and 8s + 2t + 1 (t = lane % 4), in the order of
// wgmma's A fragment (row g, row g + 8, row g, row g + 8).  Rows >= S are
// zero.  Each thread writes the slots it reads back.
// With `other` (a tensor of the same shape), also returns in dot[0], dot[1]
// this thread's share of rowsum(base ∘ other) for its two rows, summed in
// k order (the four threads of a quad hold the rest).
template <typename T, int HD>
__device__ __forceinline__ void fill_slots(float4* slots, const T* base,
                                           int row0, int S, int stride,
                                           const T* other = nullptr,
                                           float* dot = nullptr) {
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = row0 + 16 * w + (lane >> 2), r1 = r0 + 8;
  const int t = lane & 3;
  const float2 zero = make_float2(0.f, 0.f);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll (HD == 64 ? 8 : 4)
  for (int s = 0; s < HD / 8; ++s) {
    const size_t o0 = (size_t)r0 * stride + 8 * s + 2 * t;
    const size_t o1 = (size_t)r1 * stride + 8 * s + 2 * t;
    const float2 a = r0 < S ? load2(base + o0) : zero;
    const float2 b = r1 < S ? load2(base + o1) : zero;
    slots[(s * 4 + w) * 32 + lane] = make_float4(a.x, b.x, a.y, b.y);
    if (other != nullptr) {
      const float2 c = r0 < S ? load2(other + o0) : zero;
      const float2 e = r1 < S ? load2(other + o1) : zero;
      d0 = fmaf(a.y, c.y, fmaf(a.x, c.x, d0));
      d1 = fmaf(b.y, e.y, fmaf(b.x, e.x, d1));
    }
  }
  if (dot != nullptr) {
    dot[0] = d0;
    dot[1] = d1;
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor without swizzle: `lbo` bytes between the
// two core matrices of a k8 step, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}
// Step s of a K-major B of NR rows; of a transposed B of NC columns, from
// column 64 cb.
template <int NR>
__device__ __forceinline__ uint64_t kmajor_desc(const uint32_t* b, int s) {
  return smem_desc(b + 2 * s * (NR / 8) * 32, (NR / 8) * 128, 128);
}
template <int NC>
__device__ __forceinline__ uint64_t trans_desc(const uint32_t* b, int s,
                                               int cb) {
  return smem_desc(b + (2 * s * (NC / 8) + 8 * cb) * 32, (NC / 8) * 128, 128);
}

#define FA_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b^T over one 64 x N x 8 step of a warpgroup: a from registers
// (each warp's 16 rows), b (N x 8) through its descriptor; d = a b^T when
// scale_d is 0.  d[4j + e] is row 16w + g (+ 8 for e >= 2), column
// 8j + 2t (+ 1 for odd e).
template <int N>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a, uint64_t b,
                                      int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64,
                "wgmma: N is 8, 16, 32 or 64");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %8, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3},{%4,%5,%6,%7}, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7},{%8,%9,%10,%11}, %13, p, 1, 1;\n}\n"
        : FA_ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
        "{%32,%33,%34,%35}, %37, p, 1, 1;\n}\n"
        : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15},"
        "{%16,%17,%18,%19}, %21, p, 1, 1;\n}\n"
        : FA_ACC8(0), FA_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
  }
}
#undef FA_ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// One k8 step of a product in 3xTF32 (or one TF32 pass when EXACT):
// small_a big_b + big_a small_b + big_a big_b, small * small dropped.
template <int N, bool EXACT>
__device__ __forceinline__ void wgmma_step(float* d, const uint32_t* ab,
                                           const uint32_t* as, uint64_t db,
                                           uint64_t ds, int scale_d) {
  if constexpr (EXACT) {
    wgmma<N>(d, ab, db, scale_d);
  } else {
    wgmma<N>(d, as, db, scale_d);
    wgmma<N>(d, ab, ds, 1);
    wgmma<N>(d, ab, db, 1);
  }
}

// acc = A B over k8 steps [0, STEPS): A from the warpgroup's slots, split
// as they are loaded; B's step s through kmajor_desc<NR>(big / small, s).
// Groups of four steps, one commit group each; after each commit it waits
// until one group at most is in flight, so that two groups' fragments at
// most are live.  The caller waits for the last.
template <int N, int STEPS, int NR, bool EXACT>
__device__ __forceinline__ void mma_slots(float* acc, const float4* slots,
                                          const uint32_t* big,
                                          const uint32_t* small) {
  const int wl = threadIdx.x & 127;
#pragma unroll
  for (int g0 = 0; g0 < STEPS; g0 += 4) {
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 v = slots[(g0 + s) * 128 + wl];
      split_tf32<EXACT>(v.x, ab[s][0], as[s][0]);
      split_tf32<EXACT>(v.y, ab[s][1], as[s][1]);
      split_tf32<EXACT>(v.z, ab[s][2], as[s][2]);
      split_tf32<EXACT>(v.w, ab[s][3], as[s][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_step<N, EXACT>(acc, ab[s], as[s], kmajor_desc<NR>(big, g0 + s),
                           EXACT ? 0 : kmajor_desc<NR>(small, g0 + s),
                           g0 + s > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
}

// The A fragments of a product whose A is the accumulator `x` of the last
// one (N = 8 STEPS columns, as wgmma lays it out): step s takes columns
// 8s .. 8s + 7, which the permuted k order puts in the thread that holds
// them.
template <int STEPS, bool EXACT>
__device__ __forceinline__ void frags_from_acc(const float* x,
                                               uint32_t (&ab)[STEPS][4],
                                               uint32_t (&as)[STEPS][4]) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    split_tf32<EXACT>(x[4 * s + 0], ab[s][0], as[s][0]);
    split_tf32<EXACT>(x[4 * s + 2], ab[s][1], as[s][1]);
    split_tf32<EXACT>(x[4 * s + 1], ab[s][2], as[s][2]);
    split_tf32<EXACT>(x[4 * s + 3], ab[s][3], as[s][3]);
  }
}

// acc = A B with A from registers (frags_from_acc) and B the transposed
// operand of NC columns, from column 64 cb, over k8 steps [0, STEPS).  No
// fence, commit or wait: the caller's.
template <int STEPS, int NC, bool EXACT>
__device__ __forceinline__ void mma_regs(float* acc,
                                         uint32_t (&ab)[STEPS][4],
                                         uint32_t (&as)[STEPS][4],
                                         const uint32_t* big,
                                         const uint32_t* small, int cb) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    wgmma_step<64, EXACT>(acc, ab[s], as[s], trans_desc<NC>(big, s, cb),
                          EXACT ? 0 : trans_desc<NC>(small, s, cb), s > 0);
}

}  // namespace
