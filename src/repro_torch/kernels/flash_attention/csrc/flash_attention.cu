// Flash attention forward for Hopper (sm_90a), CUDA C++ on the tensor
// cores in error-compensated TF32 ("3xTF32").
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_tpu
// (the Pallas body `_body`, pallas_call at :98).  Same function: q
// (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> o (B,Sq,H,hd); scores q·k/sqrt(hd),
// optional softcap·tanh(s/softcap), causal (qi >= ki) and window
// (qi - ki < window) masks with NEG_INF = -1e30, online softmax with the
// running max m, sum l and accumulator in f32, l clamped to 1e-30 at the
// end.  GQA: q head h reads kv head h / (H/KV); K/V are never repeated.
// Sk may differ from Sq for non-causal attention (the encoder-decoder's
// cross-attention: decoder queries over every encoder frame); the key
// loop then runs to Sk, its last tile ragged.  The Pallas kernel takes its
// key blocks from q's length and attends over the first Sq keys only; the
// reference's CPU paths, which this follows, attend over all Sk.
// Key tiles that the masks cover entirely are never visited.  Training
// passes an lse pointer and gets each row's logsumexp m + log(l) as
// (B, H, Sq) f32, which the backward (flash_attention_bwd.cu) recomputes
// the probabilities from; the serving paths pass null and run the same
// arithmetic, so both write the same output bits.
//
// Precision.  Inputs f32 or bf16.  Both products (S = Q K^T and O += P V)
// run on the tensor cores (wgmma, TF32 in, f32 accumulator).  f32 operands
// take three TF32 passes, small·big + big·small + big·big of x = big +
// small (flash_common.cuh), which keeps the output within 1e-5 of an f64
// version (chip_smoke.py checks it; tests/test_torch_flash_attention.py
// emulates the route on the CPU, where one pass is ~7e-4 off, past the
// 1e-4 tolerance).  bf16 q, k, v are exact
// in TF32 and take one pass; so does P in P V then, rounded to TF32
// (2^-11 relative) where the output is rounded to bf16 (2^-8).  The score
// tile is summed afresh on each key tile (3 hd / 8 passes at most), and
// the P V tile afresh too, added to the f32 accumulator by the softmax's
// rescale acc = acc·alpha + P V, so the tensor cores' truncating
// accumulation never runs long.  Softmax statistics, exp and lse are f32;
// the output is rounded once to the input type.
//
// Bound on the card (H100 SXM, 700 W; f32 inputs, causal).  The two
// products are 4·B·H·hd·S(S+1)/2 FLOP; on this route each is three TF32
// products at 495 TFLOP/s, against q, k, v, o once at 3.35 TB/s:
//   serving prefill B=8 S=512 H=12 hd=64: 3.23 GFLOP, 19.6 us of TF32 (the
//     bound; 48.2 us of f32 FMA at 67 TFLOP/s), 50.3 MB = 15.0 us;
//   training B=16 S=256: 1.62 GFLOP = 9.8 us, 50.3 MB = 15.1 us (bytes);
//   jamba B=4 S=1024 H=32/8 hd=128: 34.4 GFLOP = 208 us of TF32 (513 us
//     of f32 FMA), 168 MB = 50 us: bound by operations.
//
// What bounded the first version (plain f32 FMA), and what this design
// does about it:
//   * CUDA cores only: both products now run on the tensor cores (wgmma
//     m64nNk8 TF32; 495 TFLOP/s against 67 of f32 FMA).  S = Q K^T takes Q
//     as A from registers (its rows kept raw in shared-memory slots in
//     fragment order, split as they are loaded) and K as B, split once per
//     tile into big/small copies in core-matrix layout.  The score
//     accumulator becomes P in registers and, by the permuted k order, the
//     A fragment of O += P V, whose B is V split transposed (hd x keys), as
//     the TF32 wgmma takes K-major operands only.  At hd 128 P V runs as
//     two 64-column blocks, at hd 256 as four.
//   * Synchronous loads: K and V tiles are copied by cp.async into one raw
//     staging tile; as soon as it is split, the next tile's copy is
//     issued, so it lands while this tile multiplies.
//   * Occupancy: hd 64 runs one warpgroup of 64 query rows with 64-key
//     tiles, 112 KB of shared memory in f32, so two CTAs share an SM and
//     hide each other's split and softmax phases (two warpgroups sharing
//     the split tiles measured no faster there).  hd 128 runs two
//     warpgroups of 64 rows sharing each split tile of 32 keys: 160 KB,
//     one CTA of eight warps an SM (64-key tiles needed 224 KB for four).
//     hd 256 (gemma2-9b, gemma3-12b) runs one warpgroup with 16-key
//     tiles: 160 KB in f32 (one CTA an SM), 112 KB in bf16 (room for two
//     CTAs an SM; 32-key bf16 tiles at 160 KB measured 3.60 against 3.19
//     ms at gemma2's prefill, tools/flash_variants.py): m64n16 score
//     products, P V four 64-column blocks.  A warpgroup skips the tiles its masks cover
//     entirely.
//   * Late (heavy causal) query tiles are issued first; the ragged last
//     query and key tiles are masked (zero-filled copies, NEG_INF
//     scores), and the caller pads nothing.
//
// What it still leaves on the table: within one CTA the split, the
// products and the softmax run one after another (a producer warpgroup
// splitting into a ring for consumers, in ping-pong, would overlap them;
// splitting V^T while S runs measured no faster); TMA would take the
// copies off the threads; a persistent schedule would end the tail of the
// causal grid.

#include "flash_common.cuh"

namespace {

// Per head dim: warpgroups of 64 query rows per CTA, and keys per tile.
// hd 64: one warpgroup, 64 keys, 112 KB in f32 (two CTAs an SM).  hd 128:
// two warpgroups sharing each split tile of 32 keys, 160 KB (one CTA of
// eight warps an SM; 64 keys would fill 224 KB for four warps).  hd 256:
// one warpgroup, whose Q slots alone take 64 KB; 16 keys a tile: 160 KB
// in f32 (32 keys would need 256 KB, or 224 KB with K and V staged in
// turn through one raw tile, where the entry spills at 255 registers) and
// 112 KB in bf16, whose raw tiles are half as large and which needs no
// small copies.  Its O accumulator is 4 x 32 f32 registers a thread.
template <int HD>
__host__ __device__ constexpr int fwd_wgs() { return HD == 128 ? 2 : 1; }
template <int HD, typename T>
__host__ __device__ constexpr int fwd_bk() {
  return HD == 64 ? 64 : HD == 128 ? 32 : 16;
}

template <int HD, typename T>
constexpr int fwd_smem_bytes() {
  // Q slots (f32), raw K and V (T), K big/small, V^T big/small.
  constexpr int BK = fwd_bk<HD, T>();
  return 64 * fwd_wgs<HD>() * HD * 4 + 2 * BK * HD * (int)sizeof(T) +
         (kExact<T> ? 2 : 4) * BK * HD * 4;
}

template <int HD, typename T>
__global__ void __launch_bounds__(128 * fwd_wgs<HD>(), HD == 64 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int causal, int window, float softcap, float scale) {
  constexpr bool EXACT = kExact<T>;
  constexpr int NC = HD / 64;            // 64-column blocks of O
  constexpr int BK = fwd_bk<HD, T>();
  constexpr int NT = 128 * fwd_wgs<HD>();
  constexpr int BQ = 64 * fwd_wgs<HD>();
  constexpr int TILE = BK * HD;          // words of one split copy

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int wg = threadIdx.x >> 7;       // this warpgroup's 64 rows
  float4* slots = reinterpret_cast<float4*>(smem_raw) + wg * (64 * HD / 4);
  uint32_t* kb = reinterpret_cast<uint32_t*>(smem_raw + BQ * HD * 4);
  uint32_t* ks = kb + TILE;
  uint32_t* vb = EXACT ? ks : ks + TILE;
  uint32_t* vs = vb + TILE;
  T* raw_k = reinterpret_cast<T*>(EXACT ? vs : vs + TILE);
  T* raw_v = raw_k + TILE;

  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int q_stride = H * HD, kv_stride = KV * HD;
  const T* qbase = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const T* kbase = k + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  const T* vbase = v + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  T* obase = o + (size_t)b * Sq * q_stride + (size_t)h * HD;

  int k_hi = Sk - 1;
  if (causal) k_hi = min(k_hi, q0 + BQ - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_lo / BK, kt_end = k_hi / BK;

  load_raw<T, HD, BK, NT>(raw_k, kbase, kt_begin * BK, Sk, kv_stride);
  load_raw<T, HD, BK, NT>(raw_v, vbase, kt_begin * BK, Sk, kv_stride);
  cp_async_commit();
  const int qw = q0 + 64 * wg;           // this warpgroup's first row
  fill_slots<T, HD>(slots, qbase, qw, Sq, q_stride);

  // This thread's rows: 16w + g and + 8 of its warpgroup's.
  const int qi0 = qw + 16 * w + g, qi1 = qi0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();                   // the tile is in; last tile's wgmma done
    split_kmajor<T, HD, BK, NT, EXACT>(kb, ks, raw_k);
    split_trans<T, HD, BK, NT, EXACT>(vb, vs, raw_v);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free
    if (kt < kt_end) {
      load_raw<T, HD, BK, NT>(raw_k, kbase, k0 + BK, Sk, kv_stride);
      load_raw<T, HD, BK, NT>(raw_v, vbase, k0 + BK, Sk, kv_stride);
      cp_async_commit();
    }

    // A warpgroup skips a tile that its masks cover entirely (the online
    // softmax would add exactly nothing for it).
    if ((causal && k0 > qw + 63) ||
        (window > 0 && k0 + BK - 1 < qw - window + 1))
      continue;
    float s[BK / 2];
    mma_slots<BK, HD / 8, BK, EXACT>(s, slots, kb, ks);
    wgmma_wait<0>();

    // Softcap, masks and the online softmax in base 2 (m, mx, and the
    // scores are x log2 e); s[4j + e] is row qi0 (qi1 for e >= 2), key
    // k0 + 8j + 2t + (e & 1).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qi = (i & 2) ? qi1 : qi0;
      const int ki = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x *= LOG2E;
      bool ok = ki < Sk;
      if (causal) ok = ok && qi >= ki;
      if (window > 0) ok = ok && qi - ki < window;
      x = ok ? x : NEG_INF;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(s[i] - mx[r]);
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }

    // O = O·alpha + P V, the tile's product summed afresh (at hd 128 one
    // 64-column block after the other, to keep the registers in bounds).
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
    frags_from_acc<BK / 8, EXACT>(s, pb, ps);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float part[32];
      wgmma_fence();
      mma_regs<BK / 8, HD, EXACT>(part, pb, ps, vb, vs, c);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[c][i] = acc[c][i] * alpha[(i >> 1) & 1] + part[i];
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? qi1 : qi0;
    if (qi >= Sq) continue;
    T* orow = obase + (size_t)qi * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(orow + 64 * c + 8 * j + 2 * t, acc[c][4 * j + 2 * r] * inv[r],
               acc[c][4 * j + 2 * r + 1] * inv[r]);
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m[r] * LN2 + logf(fmaxf(l[r], 1e-30f));
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int KV,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<HD, T>();
  constexpr int BQ = 64 * fwd_wgs<HD>();
  // Above 48 KB a kernel must opt in to dynamic shared memory; the largest
  // carveout lets two 112 KB CTAs share an SM.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_kernel<HD, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_fwd_kernel<HD, T><<<grid, 128 * fwd_wgs<HD>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and o are (B, Sq, H, hd), k and v
// (B, Sk, KV, hd); causal attention needs Sk == Sq.  lse (B, H, Sq) f32
// receives each row's logsumexp of its (scaled, softcapped, masked) scores
// for the backward, or is null (the serving paths).  Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int Sq, int Sk,
                                   int H, int KV, int hd, int dtype,
                                   int causal, int window, float softcap,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535 || (causal && Sk != Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64 && dtype == 0)
    return (int)launch<64, float>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, softcap, st);
  if (hd == 64 && dtype == 1)
    return (int)launch<64, __nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, softcap, st);
  if (hd == 128 && dtype == 0)
    return (int)launch<128, float>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, softcap, st);
  if (hd == 128 && dtype == 1)
    return (int)launch<128, __nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, softcap, st);
  if (hd == 256 && dtype == 0)
    return (int)launch<256, float>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, softcap, st);
  if (hd == 256 && dtype == 1)
    return (int)launch<256, __nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
