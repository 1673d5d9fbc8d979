// Causal GQA prefill attention (flash style), with optional softcap and
// sliding window.
//
// Replaces: src/repro/kernels/flash_prefill.py, flash_prefill
// (pl.pallas_call at :140, body _kernel at :40).
//
// What bounds it on the H100: operations.  Causal attention over S = 8192
// at llama3-8b's shape (B 2, H 32, D 128) does 4 * B * H * D * S(S+1)/2
// = 1.1 TFLOP (Q.K^T and P.V) against 0.27 GB of bytes: 1.11 ms at the
// 989 TFLOP/s of the bf16 tensor cores; at gemma2-2b's (B 2, H 8, D 256)
// 0.55 TFLOP on a global layer, 0.41 on a local one (window 4096): 0.556
// and 0.417 ms.  The P split below issues the P.V half twice, 1.5x the
// operations in all.
//
// bf16 (the serving path): a warp-specialised wgmma kernel.
//  * Work split.  One CTA per (b, hkv, query tile).  The tile's BQ = 128 / G
//    positions times their G query heads are the 128 rows of M (row r is
//    position q0 + r / G, head hkv * G + r % G; at G = 4, 32 positions), as
//    the Pallas kernel flattens (block_q, G): each K/V tile is read once
//    for all G heads.  Rows past BQ * G (G not a power of two) and
//    positions past S are computed on whatever the tile holds and never
//    written (G = 12: BQ = 10 positions, 120 live rows; the Q box is 10
//    positions of 12 heads, and its byte count, BQ * G * D * 2, is what
//    the barrier expects).  Query tiles are launched longest causal row
//    first, so the triangle leaves no tail wave.
//  * Warps.  Two consumer warpgroups of 64 rows each and one producer
//    warpgroup, 384 threads; setmaxnreg moves registers from the producer
//    (40 a thread) to the consumers (232).  One producer thread issues
//    every copy.
//  * Copies.  TMA (cp.async.bulk.tensor) loads the Q tile once and the
//    K/V tiles of BN keys (128; 64 at D = 256) through a ring of STAGES =
//    2 slots, with full barriers counting bytes and an empty barrier that
//    the 256 consumer threads release.  Tiles land in shared memory
//    swizzled by the row's bytes (128 B for D >= 64, else 64 B or 32 B; a
//    D = 128 row is two 128-byte atoms, a D = 256 row four).  The tensor
//    maps are encoded on the host with cuTensorMapEncodeTiled, a driver
//    call fetched at run time through cudaGetDriverEntryPoint(ByVersion),
//    so the library needs no -lcuda.
//    Q is a 5-d map (D, G, Hkv, S, B) whose box is one query tile of one
//    KV head; K and V are 4-d maps (D, Hkv, S, B).  Keys and queries past S
//    arrive as zeros.
//  * S = Q.K^T: wgmma m64n{BN}k16, bf16 x bf16 -> f32, both operands
//    K-major in shared memory.  Products of bf16 values are exact in f32,
//    so the logits are the f32 reference's up to the order of the sum.
//  * Softmax in registers on the accumulator fragment, in log2 units (the
//    scale folds in log2 e): the row max reduces over the quad of lanes
//    that shares a row; the row sum stays a per-thread partial until the
//    end.  Only tiles that cross the causal frontier (the last one or two)
//    or the window's lower edge take the mask arithmetic; the bulk runs a
//    loop without it, and without softcap it scales only the row max and
//    feeds exp2 one FMA.  The softcap is a template flag, so a kernel
//    without it carries no tanh.  A masked logit is the finite -1e30
//    sentinel, as in the reference.
//  * O += P.V: wgmma m64n{D}k16.  P is the register-held A operand (the
//    f32 accumulator fragment converts in place to the bf16 A fragment); V
//    is the B operand in shared memory, D-contiguous, read through wgmma's
//    transpose bit (no transposed copy).  P is split into two bf16 values
//    P = P_hi + P_lo, and both go through wgmma against the same V tile:
//    rounding P to one bf16 would leave up to 2^-9 |v| (~2e-3) in an
//    output element, far above the 1e-4 with which a short row whose V
//    rows cancel must match the f32 reference; with the split the error
//    is ~2^-17 |v|.
//  * Registers a consumer thread (of the 232 that setmaxnreg gives it): O
//    takes D / 2, the S fragment BN / 2, and P_hi with P_lo BN / 2 more
//    (built while S is live), plus two rows of m and l.  With BN = 128, O, S and P
//    are 64 + 64 + 64 = 192 at D = 128; at D = 256, O alone is 128, so the
//    tile is cut to BN = 64 keys: 128 + 32 + 32 = 192 again; D = 192
//    (deepseek-v2's MLA prefill: qk_nope + qk_rope, v padded to it, G = 1)
//    takes BN = 64 too, 96 + 32 + 32 = 160, with three 128-byte atoms a
//    row and wgmma m64n192k16 for P.V.
//  * Shared memory a CTA: Q (128 rows x D x 2 B) + 2 stages of K and V (BN
//    x D x 2 B each) + 1 KB of alignment: D = 128, 32 KB + 4 x 32 KB = 161
//    KB; D = 192, 48 KB + 4 x 24 KB = 145 KB; D = 256, 64 KB + 4 x 32 KB =
//    193 KB, of the 227 KB a block may take.  One CTA an SM either way.
//
// f32 (the card tests and the f32 SMOKE parity loop only): a CUDA-core
// kernel.  wgmma on f32 inputs is TF32, which would not hold 1e-4 against
// the f32 reference.  One block per (b, hkv, query tile of BQ positions);
// the tile's BQ * G query rows stay in shared memory with their f32
// accumulators; the KV loop is bounded by the causal frontier of the tile
// and by the window's start, so fully masked blocks are never visited.
// Masked logits inside a visited tile take the -1e30 sentinel; query rows
// past S are computed on zeros and never written.
#include "attn_common.cuh"
#include "hopper.cuh"


template <typename T>
__global__ void flash_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     T* __restrict__ out, int S, int H,
                                     int Hkv, int D, int BQ, float sm_scale,
                                     float cap, int window) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int R = BQ * G;
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int q0 = blockIdx.y * BQ;
  SoftmaxSmem s = carve_smem(smem, R, D);

  // Row r <-> (query position q0 + r / G, head h * G + r % G).
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r / G;
    float x = 0.f;
    if (qpos < S)
      x = to_f(q[(((size_t)b * S + qpos) * H + h * G + r % G) * D + d]);
    s.q[i] = x;
  }
  init_state(s, R, D);

  const int kv_hi = min(S, q0 + BQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const long long row_stride = (long long)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + h) * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D;
  for (int k0 = kv_lo; k0 < kv_hi; k0 += TM) {
    const int n = min(TM, kv_hi - k0);
    load_tile(s, kb + (size_t)k0 * row_stride, vb + (size_t)k0 * row_stride,
              n, D, row_stride);
    __syncthreads();
    tile_logits(s, R, n, D, sm_scale);
    for (int t = threadIdx.x; t < R * TM; t += blockDim.x) {
      const int r = t / TM, j = t % TM;
      if (j < n) {
        const int qpos = q0 + r / G, kpos = k0 + j;
        bool ok = kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        s.p[t] = ok ? softcap_f(s.p[t], cap) : NEG_INF_F;
      }
    }
    softmax_update(s, R, n, D);
  }

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r / G;
    if (qpos < S)
      out[(((size_t)b * S + qpos) * H + h * G + r % G) * D + d] =
          from_f<T>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}


namespace wg {

constexpr int ROWS = 128;    // query rows a CTA: two consumer warpgroups
constexpr int STAGES = 2;    // K/V ring slots
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // Keys a K/V tile: 128, and 64 at D = 192 and 256, where O's 96 or 128
  // registers leave room for an S / P fragment of 64 keys only (header
  // comment).
  static constexpr int BN = D > 128 ? 64 : 128;
  static constexpr int SWB = D * 2 < 128 ? D * 2 : 128;  // swizzle bytes
  static constexpr int W = SWB / 2;                      // columns an atom
  static constexpr int ATOMS = D / W;
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;            // K or V, one slot
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BARS * sizeof(uint64_t);
};

struct Smem {
  uint8_t* q;
  uint8_t* k;
  uint8_t* v;
  uint64_t* full_q;
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty;
};

// Online-softmax state of one consumer thread: rows r0 and r0 + 8 of its
// warpgroup's 64, and their slice of O.
template <int D>
struct State {
  float o[D / 2];
  float m[2];
  float l[2];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// p = hi + lo with hi, lo bf16: hi = round(p), lo = round(p - hi) (the
// difference is exact in f32).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// exp2 of a logit in log2 units less the row max; RAW: the logit is the
// raw product, still to be scaled.
template <bool RAW>
__device__ __forceinline__ float prob(float x, float scale_log2, float m) {
  return exp2f(RAW ? fmaf(x, scale_log2, -m) : x - m);
}

// One K/V tile (keys k0 .. k0 + BN) of a consumer warpgroup's 64 rows.
// qp[i] is the position of the thread's row i (r0, r0 + 8).
template <int D, bool MASK, bool CAP>
__device__ __forceinline__ void attend_tile(const Smem& sm,
                                            const uint8_t* qrows,
                                            State<D>& st, int k0, int slot,
                                            uint32_t phase, const int (&qp)[2],
                                            float scale_log2, float sm_scale,
                                            float cap, int window) {
  using C = Cfg<D>;
  constexpr int SWB = C::SWB;
  constexpr int BN = C::BN;
  constexpr int KSTEPS = C::W / 16;     // k16 steps in one atom row
  const int lane = threadIdx.x & 31;

  // S = Q.K^T (64 x BN, f32).
  float s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  mbar_wait(&sm.full_k[slot], phase);
  const uint8_t* kt = sm.k + slot * C::KV_BYTES;
  wgmma_fence();
  fence_regs(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int atom = kk / KSTEPS, off = (kk % KSTEPS) * 32;
    const uint64_t da =
        make_desc<SWB>(qrows + atom * ROWS * SWB + off, 16, 8 * SWB);
    const uint64_t db =
        make_desc<SWB>(kt + atom * BN * SWB + off, 16, 8 * SWB);
    wgmma_ss<BN>(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // Logits in log2 units; the sentinel where masked.  Element s[4j + e]
  // is row i = e / 2, key k0 + 8j + 2 * (lane % 4) + e % 2.  A bulk tile
  // without softcap keeps the raw logits: its row max is scaled once
  // (a positive scale keeps the order), and exp2 below takes
  // s * scale - m in one FMA.
  constexpr bool RAW = !MASK && !CAP;
  float mx[2] = {RAW ? -3.0e38f : st.m[0], RAW ? -3.0e38f : st.m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (CAP)
        x = cap * tanhf(x * sm_scale / cap) * LOG2E;
      else if (!RAW)
        x *= scale_log2;
      if (MASK) {
        const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int q = qp[e >> 1];
        bool ok = kpos <= q;
        if (window > 0) ok = ok && (q - kpos < window);
        x = ok ? x : NEG_INF_F;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if (RAW) mx[i] = fmaxf(st.m[i], mx[i] * scale_log2);
    alpha[i] = exp2f(st.m[i] - mx[i]);
    st.m[i] = mx[i];
  }

  // P = exp2(x - m), split into the bf16 A fragments of P.V: k16 step kk
  // covers s chunks 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3]).
  uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      const float p00 = prob<RAW>(s[4 * j], scale_log2, mx[0]);
      const float p01 = prob<RAW>(s[4 * j + 1], scale_log2, mx[0]);
      const float p10 = prob<RAW>(s[4 * j + 2], scale_log2, mx[1]);
      const float p11 = prob<RAW>(s[4 * j + 3], scale_log2, mx[1]);
      rs[0] += p00 + p01;
      rs[1] += p10 + p11;
      split_pair(p00, p01, p_hi[kk][2 * half], p_lo[kk][2 * half]);
      split_pair(p10, p11, p_hi[kk][2 * half + 1], p_lo[kk][2 * half + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * alpha[i] + rs[i];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= alpha[0];
    st.o[4 * j + 1] *= alpha[0];
    st.o[4 * j + 2] *= alpha[1];
    st.o[4 * j + 3] *= alpha[1];
  }

  // O += P_hi.V + P_lo.V.
  mbar_wait(&sm.full_v[slot], phase);
  const uint8_t* vt = sm.v + slot * C::KV_BYTES;
  wgmma_fence();
  fence_regs(st.o);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = make_desc<SWB>(vt + kk * 16 * SWB, BN * SWB, 8 * SWB);
    wgmma_rs<D>(st.o, p_hi[kk], db, 1);
    wgmma_rs<D>(st.o, p_lo[kk], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st.o);
  mbar_arrive(&sm.empty[slot]);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_prefill_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ out, int S, int Hkv,
                        int G, int BQ, float scale_log2, float sm_scale,
                        float cap, int window) {
  using C = Cfg<D>;
  constexpr int SWB = C::SWB;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Smem sm;
  sm.q = base;
  sm.k = sm.q + C::Q_BYTES;
  sm.v = sm.k + STAGES * C::KV_BYTES;
  sm.full_q = reinterpret_cast<uint64_t*>(sm.v + STAGES * C::KV_BYTES);
  sm.full_k = sm.full_q + 1;
  sm.full_v = sm.full_k + STAGES;
  sm.empty = sm.full_v + STAGES;

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int kv_hi = min(S, q0 + BQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BN, t_hi = (kv_hi + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(sm.full_q, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sm.full_k[i], 1);
      mbar_init(&sm.full_v[i], 1);
      mbar_init(&sm.empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      mbar_expect_tx(sm.full_q, BQ * G * D * 2);
      for (int a = 0; a < C::ATOMS; ++a)
        tma_load_5d(sm.q + a * ROWS * SWB, &tm_q, sm.full_q, a * C::W, 0, h,
                    q0, b);
      uint32_t it = 0;
      for (int t = t_lo; t < t_hi; ++t, ++it) {
        const int slot = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        mbar_wait(&sm.empty[slot], phase ^ 1);
        mbar_expect_tx(&sm.full_k[slot], C::KV_BYTES);
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load_4d(sm.k + slot * C::KV_BYTES + a * BN * SWB, &tm_k,
                      &sm.full_k[slot], a * C::W, h, t * BN, b);
        mbar_expect_tx(&sm.full_v[slot], C::KV_BYTES);
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load_4d(sm.v + slot * C::KV_BYTES + a * BN * SWB, &tm_v,
                      &sm.full_v[slot], a * C::W, h, t * BN, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wgi = threadIdx.x / 128;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) / 32;
    const int r[2] = {wgi * 64 + warp * 16 + lane / 4,
                      wgi * 64 + warp * 16 + lane / 4 + 8};
    const int qp[2] = {q0 + r[0] / G, q0 + r[1] / G};
    const uint8_t* qrows = sm.q + wgi * 64 * SWB;
    State<D> st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = NEG_INF_F;
    st.l[0] = st.l[1] = 0.f;

    // Tiles [t_lo, t_a) reach below some row's window, tiles [t_b, t_hi)
    // past the first row's causal frontier: those take the mask.
    const int mask_lo = window > 0 ? kv_hi - window : 0;
    const int t_a = max(t_lo, min(t_hi, (mask_lo + BN - 1) / BN));
    const int t_b = max(t_a, min(t_hi, (q0 + 1) / BN));
    mbar_wait(sm.full_q, 0);
    uint32_t it = 0;
    int t = t_lo;
    for (; t < t_a; ++t, ++it)
      attend_tile<D, true, CAP>(sm, qrows, st, t * BN, it % STAGES,
                           (it / STAGES) & 1, qp, scale_log2, sm_scale, cap,
                           window);
    for (; t < t_b; ++t, ++it)
      attend_tile<D, false, CAP>(sm, qrows, st, t * BN, it % STAGES,
                            (it / STAGES) & 1, qp, scale_log2, sm_scale, cap,
                            window);
    for (; t < t_hi; ++t, ++it)
      attend_tile<D, true, CAP>(sm, qrows, st, t * BN, it % STAGES,
                           (it / STAGES) & 1, qp, scale_log2, sm_scale, cap,
                           window);

    const int H = Hkv * G;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = st.l[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      st.l[i] = fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r[i] >= BQ * G || qp[i] >= S) continue;
      __nv_bfloat16* row =
          out + (((size_t)b * S + qp[i]) * H + h * G + r[i] % G) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            st.o[4 * j + 2 * i] / st.l[i], st.o[4 * j + 2 * i + 1] / st.l[i]);
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane & 3)) = v2;
      }
    }
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int Hkv, float sm_scale, float cap,
                  int window, cudaStream_t stream) {
  using C = Cfg<D>;
  const int G = H / Hkv;
  const int BQ = ROWS / G;
  const cuuint64_t e = 2;  // bytes of a bf16
  CUtensorMap tm_q, tm_k, tm_v;
  const cuuint64_t qdims[5] = {(cuuint64_t)D, (cuuint64_t)G,
                               (cuuint64_t)Hkv, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t qstr[4] = {D * e, (cuuint64_t)G * D * e,
                              (cuuint64_t)H * D * e,
                              (cuuint64_t)S * H * D * e};
  const cuuint32_t qbox[5] = {(cuuint32_t)C::W, (cuuint32_t)G, 1,
                              (cuuint32_t)BQ, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                               (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {D * e, (cuuint64_t)Hkv * D * e,
                              (cuuint64_t)S * Hkv * D * e};
  const cuuint32_t kbox[4] = {(cuuint32_t)C::W, 1, (cuuint32_t)C::BN, 1};
  const CUtensorMapSwizzle swz = Swizzle<C::SWB>::tma;
  if (!encode_map(&tm_q, q, 5, qdims, qstr, qbox, swz) ||
      !encode_map(&tm_k, k, 4, kdims, kstr, kbox, swz) ||
      !encode_map(&tm_v, v, 4, kdims, kstr, kbox, swz))
    return (int)cudaErrorInvalidValue;
  auto kernel = cap > 0.f ? flash_prefill_wgmma<D, true>
                          : flash_prefill_wgmma<D, false>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, (S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)out, S, Hkv, G, BQ, sm_scale * LOG2E,
      sm_scale, cap, window);
  return (int)cudaGetLastError();
}

}  // namespace wg

static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int Hkv, int D, float sm_scale,
                      float cap, int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const int BQ = G >= 64 ? 1 : 64 / G;  // 64 query rows per block
  const size_t smem = softmax_smem_floats(BQ * G, D) * sizeof(float);
  cudaError_t err = allow_smem(flash_prefill_kernel<float>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, (S + BQ - 1) / BQ);
  flash_prefill_kernel<float><<<grid, 256, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H,
      Hkv, D, BQ, sm_scale, cap, window);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (wgmma kernel, D in
// {16, 32, 64, 128, 192, 256}, G = H / Hkv in 1..GMAX, 16-byte aligned
// tensors).
// cap <= 0: no softcap; window <= 0: no sliding window.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int Hkv, int D, float sm_scale,
                                    float cap, int window, int dtype,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 1)
    return launch_f32(q, k, v, out, B, S, H, Hkv, D, sm_scale, cap, window,
                      st);
  const int G = H / Hkv;
  if (G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
#define WG_LAUNCH(d) \
  wg::launch<d>(q, k, v, out, B, S, H, Hkv, sm_scale, cap, window, st)
  switch (D) {
    case 16: return WG_LAUNCH(16);
    case 32: return WG_LAUNCH(32);
    case 64: return WG_LAUNCH(64);
    case 128: return WG_LAUNCH(128);
    case 192: return WG_LAUNCH(192);
    case 256: return WG_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WG_LAUNCH
}
