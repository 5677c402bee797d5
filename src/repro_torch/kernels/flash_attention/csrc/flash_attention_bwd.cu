// Flash attention backward for Hopper (sm_90a), CUDA C++ on the tensor
// cores in error-compensated TF32 ("3xTF32").
//
// Replaces: no TPU kernel.  The JAX package differentiates its attention
// automatically (there is no custom_vjp anywhere in src/repro), so this is
// the gradient that training in PyTorch needs of the forward kernel in
// flash_attention.cu, which ports
// src/repro/kernels/flash_attention/kernel.py:flash_attention_tpu.
//
// Function: given q (B,Sq,H,hd), k/v (B,Sk,KV,hd), the forward's output o
// and per-row logsumexp lse (B,H,Sq) f32, and the upstream gradient dO,
// return dq (B,Sq,H,hd), dk and dv (B,Sk,KV,hd).  With s = (q·k)/sqrt(hd), x = softcap·tanh(s/softcap) (or s),
// masked entries at NEG_INF:
//   P  = exp(x - lse)                      (recomputed, never stored)
//   D  = rowsum(dO ∘ o)
//   dV = Pᵀ dO,   dP = dO Vᵀ,   dX = P ∘ (dP - D)
//   dS = dX ∘ (1 - (x/softcap)²)           (the softcap's derivative)
//   dQ = dS K / sqrt(hd),   dK = dSᵀ q / sqrt(hd)
// Causal, window, softcap, MHA/GQA, hd 64/128/256, f32/bf16, ragged lengths
// and Sk != Sq (non-causal) as the forward takes them.
//
// Precision as in the forward: every product on the tensor cores (wgmma,
// TF32 in, f32 accumulator), three TF32 passes for f32 operands (x = big +
// small, small·small dropped), one for bf16 inputs (exact in TF32; P and
// dS then rounded to TF32, 2^-11, where the gradients are rounded to bf16,
// 2^-8).  Each tile's products are summed afresh and added to the f32
// gradient accumulators.  P, dS, D and the softcap's derivative are f32.
//
// Design: two launches, deterministic (no atomics; the same inputs give the
// same bits on every run).
//   1. dq: grid (ceil(Sq/64), H, B), late causal tiles first; one warpgroup
//      owns 64 query rows of one head.  It first computes D for its rows
//      (each thread sums its quarter of the two rows whose dO it loads
//      into its slots, then two shuffles, in a fixed order) and writes it
//      for launch 2; this replaces the first version's separate D launch.
//      Then over key steps of 32: S = Q Kᵀ and dP = dO Vᵀ (m64n32k8, Q and
//      dO as A from slots, K and V as K-major B), P and dS in registers,
//      dQ += dS K (dS as A straight from the score accumulator, K
//      transposed as B).
//   2. dkdv: grid (ceil(Sk/64), KV, B).  A CTA owns 64 keys of one kv head
//      and loops over the G = H/KV query heads of its group and the query
//      steps of 32 that can see its keys, so GQA sums inside the CTA.  It
//      computes the transposed scores Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (K and V
//      as A from slots, Q and dO as K-major B), so that Pᵀ and dSᵀ come
//      out with keys as rows: they are the A operands of dV += Pᵀ dO and
//      dK += dSᵀ Q (dO and Q transposed as B) with no exchange.  At hd 128
//      the CTA holds two warpgroups, each owning 64 columns of dK and dV
//      and computing Sᵀ and dPᵀ itself, so that neither spills; at hd 256
//      two warpgroups of 128 columns each.
//   At hd 256 the steps narrow (bwd_step): 8 keys or queries a step in
//   f32, 16 in bf16.
// Each step's Q/dO (or K/V) tile, and in dkdv its lse and D, is copied by
// cp.async into a raw staging tile, split into the B copies it feeds, and
// the next step's copy issued at once, so it lands while this step
// multiplies.  Ragged tiles are masked (zero-filled copies, p = 0); the
// caller pads nothing.
//
// Bound on the card (H100 SXM, 700 W): at the training shape (B=16, S=256,
// H=12, hd=64, causal, f32) the minimal backward is five 64-wide products
// per visible (query, key) pair (S, dP, dV, dQ, dK: 2.5x the forward's
// two), 10·B·H·hd·S(S+1)/2 = 4.04 GFLOP: 60 us of f32 FMA at 67 TFLOP/s,
// 24.5 us on this route (three TF32 products each at 495 TFLOP/s),
// against 101 MB of q, k, v, o, dO, lse, dq, dk, dv at 3.35 TB/s = 30 us:
// on this route bound by bytes.  This design recomputes S and dP in both
// launches (seven products per pair, 34 us of TF32) to stay free of
// atomics and of a dQ workspace.
//
// What bounded the first version, and what this design does about it:
//   * CUDA cores only: every product is a TF32 wgmma, 3xTF32 for f32.
//   * Synchronous loads: cp.async copies of the next step while this one
//     multiplies (above); dkdv's lse and D come with them, no longer as
//     loads the step waits for.
//   * Seven products per pair: kept (five would need atomics or a dQ
//     workspace summed in a second pass); the launch that computed D alone
//     is folded into dq.
//   * dkdv at one CTA an SM (186 registers x 256 threads): now 128 threads
//     at 251 registers and 115 KB, two CTAs an SM at hd 64 in f32.
//
// What it still leaves on the table: the two recomputed products; within
// a CTA the splits, products and elementwise work run one after another
// (warp specialisation would overlap them); 32-wide steps keep two CTAs
// on an SM at the price of m64n32 score products, and 64-wide steps at
// one CTA an SM are untried.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;          // query rows of a dq CTA
constexpr int BK = 64;          // keys of a dkdv CTA

// Keys per step of a dq CTA and queries per step of a dkdv CTA: 32 at hd
// 64 and 128.  At hd 256 the two 64-row slot operands alone take 128 KB,
// so the steps narrow until the staging fits the 227 KB a CTA may take:
// 8 (f32) or 16 (bf16) keys a dq step (192 KB), 8 or 16 queries a dkdv
// step (208 KB), with m64n8 and m64n16 score products.
template <int HD, typename T>
__host__ __device__ constexpr int bwd_step() {
  return HD <= 128 ? 32 : kExact<T> ? 16 : 8;
}
// Threads of a dkdv CTA: one warpgroup per 64 columns of dK and dV at hd
// 64 and 128; at hd 256 two warpgroups of 128 columns each (four would
// leave 128 registers a thread, where dK and dV alone take 64).
template <int HD>
__host__ __device__ constexpr int dkdv_threads() {
  return HD == 256 ? 256 : HD * 2;
}

template <int HD, typename T>
constexpr int dq_smem_bytes() {
  // Q and dO slots (f32), raw K and V (T), K, V (K-major) and K^T big/small.
  constexpr int BKQ = bwd_step<HD, T>();
  return 2 * BQ * HD * 4 + 2 * BKQ * HD * (int)sizeof(T) +
         (kExact<T> ? 3 : 6) * BKQ * HD * 4;
}

template <int HD, typename T>
constexpr int dkdv_smem_bytes() {
  // K and V slots (f32), raw Q and dO (T), Q, dO (K-major) and Q^T, dO^T
  // big/small, lse and D of two steps.
  constexpr int BQS = bwd_step<HD, T>();
  return 2 * BK * HD * 4 + 2 * BQS * HD * (int)sizeof(T) +
         (kExact<T> ? 4 : 8) * BQS * HD * 4 + 4 * BQS * 4;
}

// p and dS of one (query, key) pair: s the scaled score, lse2 the row's
// logsumexp times log2 e, ok false where a mask covers the pair.
__device__ __forceinline__ void probs_and_grad(float s, float dp, float lse2,
                                               float d_i, bool ok,
                                               float softcap, float& p,
                                               float& ds) {
  float deriv = 1.f;
  if (softcap > 0.f) {
    s = softcap * tanhf(s / softcap);
    const float tt = s / softcap;
    deriv = 1.f - tt * tt;
  }
  p = ok ? exp2f(fmaf(s, LOG2E, -lse2)) : 0.f;
  ds = p * (dp - d_i) * deriv;
}

template <int HD, typename T>
__global__ void __launch_bounds__(128, HD == 64 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dsum, T* __restrict__ dq, int Sq,
                    int Sk, int H, int KV, int causal, int window,
                    float softcap, float scale) {
  constexpr bool EXACT = kExact<T>;
  constexpr int NC = HD / 64;
  constexpr int BKQ = bwd_step<HD, T>();
  constexpr int TILE = BKQ * HD;
  constexpr int NT = 128;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float4* q_slots = reinterpret_cast<float4*>(smem_raw);
  float4* do_slots = q_slots + BQ * HD / 4;
  uint32_t* kb = reinterpret_cast<uint32_t*>(do_slots + BQ * HD / 4);
  uint32_t* ks = kb + TILE;
  uint32_t* vb = EXACT ? ks : ks + TILE;
  uint32_t* vs = vb + TILE;
  uint32_t* ktb = EXACT ? vs : vs + TILE;
  uint32_t* kts = ktb + TILE;
  T* raw_k = reinterpret_cast<T*>(EXACT ? kts : kts + TILE);
  T* raw_v = raw_k + TILE;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int q_stride = H * HD, kv_stride = KV * HD;
  const size_t q_off = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * Sk * kv_stride + (size_t)kvh * HD;

  int k_hi = Sk - 1;
  if (causal) k_hi = min(k_hi, q0 + BQ - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_lo / BKQ, kt_end = k_hi / BKQ;

  load_raw<T, HD, BKQ, NT>(raw_k, k + kv_off, kt_begin * BKQ, Sk, kv_stride);
  load_raw<T, HD, BKQ, NT>(raw_v, v + kv_off, kt_begin * BKQ, Sk, kv_stride);
  cp_async_commit();
  // D of this thread's rows qi0 = q0 + 16w + g and qi1 = qi0 + 8 from the
  // dO values its slots take and O at the same places: each thread of the
  // quad sums its quarter in k order, then two shuffles.
  const int qi0 = q0 + 16 * w + g, qi1 = qi0 + 8;
  const float* lse_row = lse + ((size_t)b * H + h) * Sq;
  float* d_row = dsum + ((size_t)b * H + h) * Sq;
  float d_i[2], lse_i[2];
  lse_i[0] = qi0 < Sq ? lse_row[qi0] * LOG2E : 0.f;
  lse_i[1] = qi1 < Sq ? lse_row[qi1] * LOG2E : 0.f;
  fill_slots<T, HD>(do_slots, dout + q_off, q0, Sq, q_stride, o + q_off, d_i);
  fill_slots<T, HD>(q_slots, q + q_off, q0, Sq, q_stride);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_i[r] += __shfl_xor_sync(0xffffffffu, d_i[r], 1);
    d_i[r] += __shfl_xor_sync(0xffffffffu, d_i[r], 2);
    const int qi = r ? qi1 : qi0;
    if (qi < Sq && t == 0) d_row[qi] = d_i[r];
  }

  float dq_acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[c][i] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BKQ;
    cp_async_wait_all();
    __syncthreads();                   // the tile is in; last step's wgmma done
    split_kmajor<T, HD, BKQ, NT, EXACT>(kb, ks, raw_k);
    split_kmajor<T, HD, BKQ, NT, EXACT>(vb, vs, raw_v);
    split_trans<T, HD, BKQ, NT, EXACT>(ktb, kts, raw_k);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free
    if (kt < kt_end) {
      load_raw<T, HD, BKQ, NT>(raw_k, k + kv_off, k0 + BKQ, Sk, kv_stride);
      load_raw<T, HD, BKQ, NT>(raw_v, v + kv_off, k0 + BKQ, Sk, kv_stride);
      cp_async_commit();
    }

    float s[BKQ / 2], dp[BKQ / 2];
    mma_slots<BKQ, HD / 8, BKQ, EXACT>(s, q_slots, kb, ks);
    mma_slots<BKQ, HD / 8, BKQ, EXACT>(dp, do_slots, vb, vs);
    wgmma_wait<0>();

    // s[4j + e]: row qi0 (qi1 for e >= 2), key k0 + 8j + 2t + (e & 1).
#pragma unroll
    for (int i = 0; i < BKQ / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int qi = r ? qi1 : qi0;
      const int ki = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      bool ok = qi < Sq && ki < Sk;
      if (causal) ok = ok && qi >= ki;
      if (window > 0) ok = ok && qi - ki < window;
      float p;
      probs_and_grad(s[i] * scale, dp[i], lse_i[r], d_i[r], ok, softcap, p,
                     s[i]);
    }

    // dQ += dS K, the step's product summed afresh (one 64-column block
    // after the other).
    uint32_t ab[BKQ / 8][4], as[BKQ / 8][4];
    frags_from_acc<BKQ / 8, EXACT>(s, ab, as);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float part[32];
      wgmma_fence();
      mma_regs<BKQ / 8, HD, EXACT>(part, ab, as, ktb, kts, c);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[c][i] += part[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? qi1 : qi0;
    if (qi >= Sq) continue;
    T* row = dq + q_off + (size_t)qi * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(row + 64 * c + 8 * j + 2 * t, dq_acc[c][4 * j + 2 * r] * scale,
               dq_acc[c][4 * j + 2 * r + 1] * scale);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(dkdv_threads<HD>(), HD == 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      int causal, int window, float softcap, float scale) {
  constexpr bool EXACT = kExact<T>;
  constexpr int NT = dkdv_threads<HD>();
  constexpr int NCW = HD / 64 / (NT / 128);   // 64-column blocks a warpgroup
  constexpr int BQS = bwd_step<HD, T>();
  constexpr int TILE = BQS * HD;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float4* k_slots = reinterpret_cast<float4*>(smem_raw);
  float4* v_slots = k_slots + BK * HD / 4;
  uint32_t* qb_ = reinterpret_cast<uint32_t*>(v_slots + BK * HD / 4);
  uint32_t* qs_ = qb_ + TILE;
  uint32_t* dob = EXACT ? qs_ : qs_ + TILE;
  uint32_t* dos = dob + TILE;
  uint32_t* qtb = EXACT ? dos : dos + TILE;
  uint32_t* qts = qtb + TILE;
  uint32_t* dotb = EXACT ? qts : qts + TILE;
  uint32_t* dots = dotb + TILE;
  T* raw_q = reinterpret_cast<T*>(EXACT ? dots : dots + TILE);
  T* raw_do = raw_q + TILE;
  float* lse_s = reinterpret_cast<float*>(raw_do + TILE);   // [2][BQS]
  float* d_s = lse_s + 2 * BQS;                             // [2][BQS]

  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;       // this warpgroup's 64 NCW columns
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;        // low key tiles see the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int q_stride = H * HD, kv_stride = KV * HD;
  const size_t kv_off = (size_t)b * Sk * kv_stride + (size_t)kvh * HD;

  // Query steps that can see keys k0 .. min(k0 + 63, Sk - 1).
  const int nsteps_all = (Sq + BQS - 1) / BQS;
  const int qs_begin = causal ? k0 / BQS : 0;
  int qs_end = nsteps_all - 1;
  if (window > 0)
    qs_end = min(qs_end, (min(k0 + BK - 1, Sk - 1) + window - 1) / BQS);
  const int nsteps = qs_end - qs_begin + 1;
  const int total = G * nsteps;

  auto q_offset = [&](int it) {
    return (size_t)b * Sq * q_stride + (size_t)(kvh * G + it / nsteps) * HD;
  };
  auto q_start = [&](int it) { return (qs_begin + it % nsteps) * BQS; };
  // Step it's Q and dO rows, and its lse and D into buffer it % 2.
  auto load_step = [&](int it) {
    load_raw<T, HD, BQS, NT>(raw_q, q + q_offset(it), q_start(it), Sq,
                             q_stride);
    load_raw<T, HD, BQS, NT>(raw_do, dout + q_offset(it), q_start(it), Sq,
                             q_stride);
    if (threadIdx.x < 2 * BQS) {
      const int i = threadIdx.x % BQS, qi = q_start(it) + i;
      const float* src = (threadIdx.x < BQS ? lse : dsum) +
                         ((size_t)b * H + kvh * G + it / nsteps) * Sq;
      float* dst = (threadIdx.x < BQS ? lse_s : d_s) + (it & 1) * BQS + i;
      cp_async4(dst, qi < Sq ? src + qi : src, qi < Sq ? 4 : 0);
    }
    cp_async_commit();
  };

  load_step(0);
  if (wg == 0) {
    fill_slots<T, HD>(k_slots, k + kv_off, k0, Sk, kv_stride);
    fill_slots<T, HD>(v_slots, v + kv_off, k0, Sk, kv_stride);
  }

  // This thread's keys: k0 + 16w + g and + 8, and whether each lies
  // below Sk (taken once: Sk is not needed past this point).
  const int ki0 = k0 + 16 * w + g, ki1 = ki0 + 8;
  const bool k_in[2] = {ki0 < Sk, ki1 < Sk};
  float dk_acc[NCW][32], dv_acc[NCW][32];
#pragma unroll
  for (int c = 0; c < NCW; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int q0 = q_start(it);
    const float* lse_b = lse_s + (it & 1) * BQS;
    const float* d_b = d_s + (it & 1) * BQS;
    cp_async_wait_all();
    __syncthreads();                   // the tile is in; last step's wgmma done
    split_kmajor<T, HD, BQS, NT, EXACT>(qb_, qs_, raw_q);
    split_kmajor<T, HD, BQS, NT, EXACT>(dob, dos, raw_do);
    split_trans<T, HD, BQS, NT, EXACT>(qtb, qts, raw_q);
    split_trans<T, HD, BQS, NT, EXACT>(dotb, dots, raw_do);
    fence_to_tensor_cores();
    __syncthreads();                   // the raw tile is free
    if (it + 1 < total) load_step(it + 1);

    float st[BQS / 2], dpt[BQS / 2];
    mma_slots<BQS, HD / 8, BQS, EXACT>(st, k_slots, qb_, qs_);
    mma_slots<BQS, HD / 8, BQS, EXACT>(dpt, v_slots, dob, dos);
    wgmma_wait<0>();

    // st[4j + e]: key ki0 (ki1 for e >= 2), query q0 + 8j + 2t + (e & 1).
    float pt[BQS / 2];
#pragma unroll
    for (int i = 0; i < BQS / 2; ++i) {
      const int ki = (i & 2) ? ki1 : ki0;
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      const int qi = q0 + c;
      bool ok = qi < Sq && k_in[(i >> 1) & 1];
      if (causal) ok = ok && qi >= ki;
      if (window > 0) ok = ok && qi - ki < window;
      probs_and_grad(st[i] * scale, dpt[i], lse_b[c] * LOG2E, d_b[c], ok,
                     softcap, pt[i], dpt[i]);
    }

    // dV += Pᵀ dO and dK += dSᵀ Q over this warpgroup's columns, each
    // step's product summed afresh.
    constexpr int KS = BQS / 8;
    uint32_t pb[KS][4], ps[KS][4], sb[KS][4], ss[KS][4];
    frags_from_acc<KS, EXACT>(pt, pb, ps);
    frags_from_acc<KS, EXACT>(dpt, sb, ss);
    if constexpr (NCW == 1) {
      float part_v[32], part_k[32];
      wgmma_fence();
      mma_regs<KS, HD, EXACT>(part_v, pb, ps, dotb, dots, wg);
      mma_regs<KS, HD, EXACT>(part_k, sb, ss, qtb, qts, wg);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dv_acc[0][i] += part_v[i];
        dk_acc[0][i] += part_k[i];
      }
    } else {
      // One 64-column product at a time: a single part stays live beside
      // the NCW-block accumulators.
#pragma unroll
      for (int c = 0; c < NCW; ++c) {
        float part[32];
        wgmma_fence();
        mma_regs<KS, HD, EXACT>(part, pb, ps, dotb, dots, wg * NCW + c);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) dv_acc[c][i] += part[i];
        wgmma_fence();
        mma_regs<KS, HD, EXACT>(part, sb, ss, qtb, qts, wg * NCW + c);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) dk_acc[c][i] += part[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = r ? ki1 : ki0;
    if (!k_in[r]) continue;
#pragma unroll
    for (int c = 0; c < NCW; ++c) {
      const int col = 64 * (wg * NCW + c);
      T* krow = dk + kv_off + (size_t)ki * kv_stride + col;
      T* vrow = dv + kv_off + (size_t)ki * kv_stride + col;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store2(krow + 8 * j + 2 * t, dk_acc[c][4 * j + 2 * r] * scale,
               dk_acc[c][4 * j + 2 * r + 1] * scale);
        store2(vrow + 8 * j + 2 * t, dv_acc[c][4 * j + 2 * r],
               dv_acc[c][4 * j + 2 * r + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <int HD, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dsum, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KV, int causal, int window,
                       float softcap, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  constexpr int dq_smem = dq_smem_bytes<HD, T>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<HD, T>, dq_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD, T><<<dim3((Sq + BQ - 1) / BQ, H, B), 128, dq_smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), Sq, Sk, H,
      KV, causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kv_smem = dkdv_smem_bytes<HD, T>();
  err = prepare(flash_bwd_dkdv_kernel<HD, T>, kv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<HD, T><<<dim3((Sk + BK - 1) / BK, KV, B),
                                 dkdv_threads<HD>(), kv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it).
// q, o, dout and dq are (B, Sq, H, hd), k, v, dk and dv (B, Sk, KV, hd);
// causal attention needs Sk == Sq.  lse (B, H, Sq) f32 from the forward;
// dsum (B, H, Sq) f32 is scratch, D as the dq launch writes it for the dkdv
// launch.  Returns the first cudaError_t (0 = both launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* dsum, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int dtype, int causal, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535 || (causal && Sk != Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_BWD(HD_, T_)                                                      \
  return (int)launch_bwd<HD_, T_>(q, k, v, o, dout, lse, dsum, dq, dk, dv,   \
                                  B, Sq, Sk, H, KV, causal, window, softcap, \
                                  st)
  if (hd == 64 && dtype == 0) FA_BWD(64, float);
  if (hd == 64 && dtype == 1) FA_BWD(64, __nv_bfloat16);
  if (hd == 128 && dtype == 0) FA_BWD(128, float);
  if (hd == 128 && dtype == 1) FA_BWD(128, __nv_bfloat16);
  if (hd == 256 && dtype == 0) FA_BWD(256, float);
  if (hd == 256 && dtype == 1) FA_BWD(256, __nv_bfloat16);
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
