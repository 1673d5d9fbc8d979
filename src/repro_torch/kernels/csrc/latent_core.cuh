// The latent decode core shared by latent_decode.cu's kernels: decode
// attention of G <= 128 query heads over ONE wide key/value head, as MLA's
// absorbed decode gives it (deepseek-v2: q_eff (B, 128, 576) in f32 over
// the latent cache [c_kv, k_pe] (B, 1, S, 576)), where decode_core.cuh's
// design does not reach: its p.V pass gives each lane 8 columns (72 lanes a
// row at D = 576), and its register accumulator acc[GB][8] already takes
// 255 registers a thread at GB = 16, while 128 heads x 576 columns of f32
// accumulator are 295 KB, more than an SM's registers.
//
// What bounds the work on the H100: operations.  Every latent row is read
// by all 128 heads: 4 * 128 * 576 flops a row of 1152 bytes (bf16), ~128
// flops a byte, where GQA decode ran at ~2.  The query stays in f32 (the
// reference einsum prefers f32), so the arithmetic is f32 on the CUDA
// cores (67 TFLOP/s), not the tensor cores.  The design:
//
//  * Head tiles.  A block takes HT = 16 heads (a grid dimension: 8 tiles
//    at G = 128) and a chunk of rows; its 8 warps own 2 heads each, and a
//    warp's 32 lanes own the row's columns in pairs (pair 32 j + lane, j <
//    NP: 9 pairs, 18 columns a lane at D = 576).  A lane keeps its 2 heads'
//    query columns (36 f32) and accumulator columns (36 f32) in registers,
//    so no accumulator crosses warps, and neither does the softmax.  The
//    8 tiles read the same rows, 7 of 8 times from L2.
//  * Loads.  A K/V tile of ROWS = 16 rows goes to shared memory with
//    cp.async 16-byte copies (rows past the chunk zero-filled), double
//    buffered; K rows carry 16 bytes of padding.  Every warp reads the
//    staged rows as column pairs (one 4-byte bf16 pair a lane: 128 bytes a
//    warp load, no bank conflict).
//  * Logits.  For each of the tile's 16 rows a lane sums its columns'
//    products for its 2 heads; the 32 partial dots (16 rows x 2 heads) are
//    then reduce-scattered over the warp in 31 shuffles, after which lane l
//    holds the full dot of row l % 16 and head l / 16.
//  * Softmax.  The 16 lanes of a head take the tile's max and sum in 4
//    shuffles each; m and l are per head, held by that head's lanes.
//  * p.V.  Each row's 2 weights are broadcast from their lanes, and each
//    lane adds p * v into its 36 accumulator columns.
//  * Chunks and merges.  The caller splits the rows into chunks (blocks),
//    each leaving an unnormalised partial (acc, m, l) per head; the last
//    block of a (b, hkv, head tile) to finish (an atomic ticket) merges
//    them exactly.  Stage 1's scores, a max over all G heads, cross the
//    tiles through a scratch row per tile and a second ticket per (b, hkv).
//
// Masking follows decode_core.cuh: a logit the caller sets to the -1e30
// sentinel takes part in the softmax; rows past the chunk and heads past G
// do not exist (p = 0, never written).  Partials are unnormalised.
#pragma once

#include "decode_core.cuh"

namespace lc {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HPW = 2;             // heads a warp
constexpr int HT = HPW * WARPS;    // heads a block (a head tile)
constexpr int ROWS = 16;           // rows a K/V tile: 16 rows x 2 heads = 32
constexpr int STAGES = 2;          // K/V tiles in flight a block
constexpr int KPAD = 16;           // bytes of padding after each staged K row
constexpr int GMAX = 128;          // largest group the wrappers pass

// Geometry of rows of D elements of TK.
template <typename TK, int D>
struct Geo {
  static constexpr int PAIRS = D / 2;                  // column pairs a row
  static constexpr int NP = (PAIRS + 31) / 32;         // pairs a lane
  static constexpr int NC = 2 * NP;                    // columns a lane
  static constexpr bool FULL = PAIRS % 32 == 0;        // every lane busy
  static constexpr int ROW_BYTES = D * (int)sizeof(TK);
  static constexpr int KROW = ROW_BYTES + KPAD;        // staged K row stride
  static constexpr int CPR = ROW_BYTES / 16;           // copies a row
  static constexpr int KBYTES = ROWS * KROW;
  static constexpr int STAGE = KBYTES + ROWS * ROW_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(D % 2 == 0 && ROW_BYTES % 16 == 0,
                "rows must be whole 16-byte copies");
};

// A column pair of a row, widened to f32.  One-byte rows (a quantized
// arena's int8 / fp8 e4m3 codes) widen two codes at once, exactly (e4m3 ->
// f16 -> f32, as decode_core.cuh's smem8); their scale is the caller's.
__device__ __forceinline__ float2 pair_at(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_at(const int8_t* p) {
  const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
  return make_float2((float)(int8_t)(u & 0xffu), (float)(int8_t)(u >> 8));
}
__device__ __forceinline__ float2 pair_at(const __nv_fp8_e4m3* p) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3)));
}
// A pair of a decrement row, f32 or TK.
template <typename TK>
__device__ __forceinline__ float2 dec_pair(const void* p, bool f32,
                                           size_t i) {
  return f32 ? pair_at(reinterpret_cast<const float*>(p) + i)
             : pair_at(reinterpret_cast<const TK*>(p) + i);
}

// One warp's state: its 2 heads' query and accumulator columns, and the
// online-softmax m, l of head lane / 16.
template <int D>
struct State {
  static constexpr int NC = Geo<float, D>::NC;
  float q[HPW][NC];
  float acc[HPW][NC];
  float m = NEG_INF_F, l = 0.f;
};

// Heads g0, g0 + 1 of the query rows at qb (f32, rows of D), zero past G.
template <int D>
__device__ __forceinline__ void load_q(State<D>& st, const float* qb, int g0,
                                       int G) {
  using Gm = Geo<float, D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < HPW; ++h)
#pragma unroll
    for (int j = 0; j < Gm::NP; ++j) {
      const int p = 32 * j + lane;
      float2 t = make_float2(0.f, 0.f);
      if (g0 + h < G && (Gm::FULL || p < Gm::PAIRS))
        t = pair_at(qb + (size_t)(g0 + h) * D + 2 * p);
      st.q[h][2 * j] = t.x;
      st.q[h][2 * j + 1] = t.y;
      st.acc[h][2 * j] = 0.f;
      st.acc[h][2 * j + 1] = 0.f;
    }
}

// Copy rows [r0, r0 + ROWS) of the span (k, v: its first row, n rows) into
// a stage (K rows padded); rows >= n are zero-filled.  v == nullptr copies
// K only.
template <typename TK, int D>
__device__ __forceinline__ void issue_tile(char* stage, const TK* k,
                                           const TK* v, int r0, int n) {
  using Gm = Geo<TK, D>;
  const char* kb = reinterpret_cast<const char*>(k);
  const char* vb = reinterpret_cast<const char*>(v);
  for (int i = threadIdx.x; i < ROWS * Gm::CPR; i += blockDim.x) {
    const int r = i / Gm::CPR, c = i % Gm::CPR;
    const bool ok = r0 + r < n;
    const size_t src = (size_t)(r0 + r) * Gm::ROW_BYTES + c * 16;
    dc::cp_async16(stage + r * Gm::KROW + c * 16, ok ? kb + src : kb,
                   ok ? 16 : 0);
    if (v != nullptr)
      dc::cp_async16(stage + Gm::KBYTES + r * Gm::ROW_BYTES + c * 16,
                     ok ? vb + src : vb, ok ? 16 : 0);
  }
}

template <int O>
__device__ __forceinline__ void rs_step(float (&x)[2 * ROWS], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? x[i] : x[i + O];
    const float keep = up ? x[i + O] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The raw dots q.k of the staged K tile's ROWS rows for the warp's 2
// heads, reduce-scattered: lane l returns the dot of row l % ROWS and head
// l / ROWS.
template <typename TK, int D>
__device__ __forceinline__ float tile_dots(const char* kt,
                                           const State<D>& st) {
  using Gm = Geo<TK, D>;
  const int lane = threadIdx.x & 31;
  float x[2 * ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const TK* kr = reinterpret_cast<const TK*>(kt + r * Gm::KROW);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < Gm::NP; ++j) {
      const int p = 32 * j + lane;
      if (Gm::FULL || p < Gm::PAIRS) {
        const float2 kv = pair_at(kr + 2 * p);
        d0 = fmaf(st.q[0][2 * j], kv.x, d0);
        d0 = fmaf(st.q[0][2 * j + 1], kv.y, d0);
        d1 = fmaf(st.q[1][2 * j], kv.x, d1);
        d1 = fmaf(st.q[1][2 * j + 1], kv.y, d1);
      }
    }
    x[r] = d0;
    x[ROWS + r] = d1;
  }
  rs_step<16>(x, lane);
  rs_step<8>(x, lane);
  rs_step<4>(x, lane);
  rs_step<2>(x, lane);
  rs_step<1>(x, lane);
  return x[0];
}

// The identity row hook of stream(): no per-row scale.
struct Unscaled {
  __device__ __forceinline__ float operator()(float x, int) const {
    return x;
  }
};

// The block's span of n rows at (k, v) for this warp's heads g0, g0 + 1
// (all warps call it: it syncs the block), into st.  logit(raw, r) turns
// row r's raw dot of one head into its logit (scale, softcap, bias or
// sentinel); it is called for rows r < n and heads < G.  With scores !=
// nullptr, scores[r] takes row r's max over the block's live heads of
// score(raw, r) (stage 1's scores, uncapped), for r < n.  pscale(p, r)
// weighs row r's p entering p.V (stage 1's per-row v-scale; l takes p
// unscaled).
template <typename TK, int D, typename Logit, typename Score = Unscaled,
          typename PScale = Unscaled>
__device__ __forceinline__ void stream(const TK* k, const TK* v, int n,
                                       int g0, int G, char* smem,
                                       State<D>& st, const Logit& logit,
                                       float* scores = nullptr,
                                       const Score& score = Score(),
                                       const PScale& pscale = PScale()) {
  using Gm = Geo<TK, D>;
  __shared__ float sc_s[WARPS * ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (n + ROWS - 1) / ROWS;
  const int r_me = lane % ROWS;
  const bool head_live = g0 + lane / ROWS < G;
  if (ntiles > 0) issue_tile<TK, D>(smem, k, v, 0, n);
  dc::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      issue_tile<TK, D>(smem + ((t + 1) % STAGES) * Gm::STAGE, k, v,
                        (t + 1) * ROWS, n);
    dc::cp_async_commit();
    dc::cp_async_wait<1>();
    __syncthreads();
    const char* stg = smem + (t % STAGES) * Gm::STAGE;
    const float raw = tile_dots<TK, D>(stg, st);
    const int row = t * ROWS + r_me;
    const bool live = head_live && row < n;
    if (scores != nullptr) {
      float s = live ? score(raw, row) : NEG_INF_F;
      s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, ROWS));
      if (lane < ROWS) sc_s[warp * ROWS + lane] = s;
    }
    const float lg = live ? logit(raw, row) : NEG_INF_F;
    float mx = lg;
#pragma unroll
    for (int o = 1; o < ROWS; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(st.m, mx);
    const float alpha = __expf(st.m - m_new);
    const float p = live ? __expf(lg - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int o = 1; o < ROWS; o <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    st.l = st.l * alpha + ps;
    st.m = m_new;
    const float a0 = __shfl_sync(0xffffffffu, alpha, 0);
    const float a1 = __shfl_sync(0xffffffffu, alpha, ROWS);
#pragma unroll
    for (int c = 0; c < Gm::NC; ++c) {
      st.acc[0][c] *= a0;
      st.acc[1][c] *= a1;
    }
    // p.V; rows past n carry p = 0 and zero-filled values.
    const float pv = live ? pscale(p, row) : 0.f;
    const TK* vt = reinterpret_cast<const TK*>(stg + Gm::KBYTES);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p0 = __shfl_sync(0xffffffffu, pv, r);
      const float p1 = __shfl_sync(0xffffffffu, pv, ROWS + r);
#pragma unroll
      for (int j = 0; j < Gm::NP; ++j) {
        const int pi = 32 * j + lane;
        if (Gm::FULL || pi < Gm::PAIRS) {
          const float2 vv = pair_at(vt + (size_t)r * D + 2 * pi);
          st.acc[0][2 * j] = fmaf(p0, vv.x, st.acc[0][2 * j]);
          st.acc[0][2 * j + 1] = fmaf(p0, vv.y, st.acc[0][2 * j + 1]);
          st.acc[1][2 * j] = fmaf(p1, vv.x, st.acc[1][2 * j]);
          st.acc[1][2 * j + 1] = fmaf(p1, vv.y, st.acc[1][2 * j + 1]);
        }
      }
    }
    __syncthreads();  // the stage is refilled at t + 1 (tile t + 2)
    if (scores != nullptr && threadIdx.x < ROWS &&
        t * ROWS + threadIdx.x < n) {
      float best = NEG_INF_F;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        best = fmaxf(best, sc_s[w * ROWS + threadIdx.x]);
      scores[t * ROWS + threadIdx.x] = best;
    }
  }
  dc::cp_async_wait<0>();
}

// Fold one row of weight -1 into the warp's heads: the decrement of a
// selected cluster's centroid (its stage-1 term).  dl[h]: the row's logit
// for head h (the sentinel where masked); vrow: the row's values (f32 or
// TK), read at the lane's columns.
template <typename TK, int D>
__device__ __forceinline__ void fold_decrement(State<D>& st,
                                               const float (&dl)[HPW],
                                               const void* vrow, bool f32) {
  using Gm = Geo<float, D>;
  const int lane = threadIdx.x & 31;
  float m2[HPW], l2[HPW];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const float m = __shfl_sync(0xffffffffu, st.m, h * ROWS);
    const float l = __shfl_sync(0xffffffffu, st.l, h * ROWS);
    m2[h] = fmaxf(m, dl[h]);
    const float e1 = expf(m - m2[h]), e2 = expf(dl[h] - m2[h]);
    l2[h] = l * e1 - e2;
#pragma unroll
    for (int j = 0; j < Gm::NP; ++j) {
      const int p = 32 * j + lane;
      if (Gm::FULL || p < Gm::PAIRS) {
        const float2 vv = dec_pair<TK>(vrow, f32, 2 * p);
        st.acc[h][2 * j] = st.acc[h][2 * j] * e1 - vv.x * e2;
        st.acc[h][2 * j + 1] = st.acc[h][2 * j + 1] * e1 - vv.y * e2;
      }
    }
  }
  st.m = lane < ROWS ? m2[0] : m2[1];
  st.l = lane < ROWS ? l2[0] : l2[1];
}

// The full dots of the warp's 2 heads with one row (f32 or TK) of D
// elements; every lane returns both.
template <typename TK, int D>
__device__ __forceinline__ void row_dots(const State<D>& st, const void* row,
                                         bool f32, float (&d)[HPW]) {
  using Gm = Geo<float, D>;
  const int lane = threadIdx.x & 31;
  d[0] = d[1] = 0.f;
#pragma unroll
  for (int j = 0; j < Gm::NP; ++j) {
    const int p = 32 * j + lane;
    if (Gm::FULL || p < Gm::PAIRS) {
      const float2 kv = dec_pair<TK>(row, f32, 2 * p);
#pragma unroll
      for (int h = 0; h < HPW; ++h)
        d[h] = fmaf(st.q[h][2 * j], kv.x, fmaf(st.q[h][2 * j + 1], kv.y,
                                                d[h]));
    }
  }
#pragma unroll
  for (int h = 0; h < HPW; ++h) d[h] = warp_sum(d[h]);
}

// Write the warp's heads: the normalised output with one part, else the
// part's unnormalised partial.  rows of (b, hkv, head): row0 + g.
template <bool SIGNED, int D>
__device__ __forceinline__ void write_out(const State<D>& st, int g0, int G,
                                          size_t row0, int nparts, int part,
                                          float* o, float* m_out,
                                          float* l_out, float* o_part,
                                          float* m_part, float* l_part) {
  using Gm = Geo<float, D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const float m = __shfl_sync(0xffffffffu, st.m, h * ROWS);
    const float l = __shfl_sync(0xffffffffu, st.l, h * ROWS);
    if (g0 + h >= G) continue;
    const size_t row = row0 + g0 + h;
#pragma unroll
    for (int j = 0; j < Gm::NP; ++j) {
      const int p = 32 * j + lane;
      if (!Gm::FULL && p >= Gm::PAIRS) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = st.acc[h][2 * j + e];
        if (nparts == 1)
          o[row * D + 2 * p + e] = dc::normalise<SIGNED>(a, l);
        else
          o_part[(row * nparts + part) * D + 2 * p + e] = a;
      }
    }
    if (lane == 0) {
      if (nparts == 1) {
        m_out[row] = m;
        l_out[row] = l;
      } else {
        m_part[row * nparts + part] = m;
        l_part[row * nparts + part] = l;
      }
    }
  }
}

// Takes a ticket of `count`; true in the block that took the last one,
// which resets it to 0 (launches sharing the tickets run on one stream).
// The block's writes are fenced before, the last block's reads after.
__device__ __forceinline__ bool last_ticket(unsigned* ticket, int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == (unsigned)count - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The exact merge of the nparts partials of the block's head tile (heads
// g0 .. g0 + HT - 1 of rows row0 + g), by the last block of the tile: m the
// max, l the sum of l_s exp(m_s - m) (signed for stage 2), o the same sum
// of the partials' acc, normalised.  One warp a head pair; the partials of
// other blocks are read from L2 (__ldcg).
template <bool SIGNED, int D>
__device__ __forceinline__ void merge_if_last(
    unsigned* ticket, int nparts, int G, int tile_g0, size_t row0,
    const float* o_part, const float* m_part, const float* l_part, float* o,
    float* m_out, float* l_out) {
  using Gm = Geo<float, D>;
  if (!last_ticket(ticket, nparts)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int g = tile_g0 + warp * HPW + h;
    if (g >= G) continue;
    const size_t row = row0 + g;
    const float* mp = m_part + row * nparts;
    const float* lp = l_part + row * nparts;
    float mx = NEG_INF_F;
    for (int s = 0; s < nparts; ++s) mx = fmaxf(mx, __ldcg(mp + s));
    float ls = 0.f;
    float a[Gm::NC];
#pragma unroll
    for (int c = 0; c < Gm::NC; ++c) a[c] = 0.f;
    for (int s = 0; s < nparts; ++s) {
      const float w = expf(__ldcg(mp + s) - mx);
      ls = fmaf(__ldcg(lp + s), w, ls);
      const float* op = o_part + (row * nparts + s) * D;
#pragma unroll
      for (int j = 0; j < Gm::NP; ++j) {
        const int p = 32 * j + lane;
        if (Gm::FULL || p < Gm::PAIRS) {
          a[2 * j] = fmaf(__ldcg(op + 2 * p), w, a[2 * j]);
          a[2 * j + 1] = fmaf(__ldcg(op + 2 * p + 1), w, a[2 * j + 1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < Gm::NP; ++j) {
      const int p = 32 * j + lane;
      if (Gm::FULL || p < Gm::PAIRS) {
        o[row * D + 2 * p] = dc::normalise<SIGNED>(a[2 * j], ls);
        o[row * D + 2 * p + 1] = dc::normalise<SIGNED>(a[2 * j + 1], ls);
      }
    }
    if (lane == 0) {
      m_out[row] = mx;
      l_out[row] = ls;
    }
  }
}

// Runs the statements (which must return) with `constexpr int kD = D` for
// the latent widths the kernels are built for (LATENT_HEAD_DIMS in
// repro_torch/kernels/_build.py): deepseek-v2's SMOKE and full-width
// kv_lora + rope; any other D returns cudaErrorInvalidValue.
#define DISPATCH_LATENT_DIM(D, ...)                   \
  switch (D) {                                        \
    case 48: { constexpr int kD = 48; __VA_ARGS__ }   \
    case 576: { constexpr int kD = 576; __VA_ARGS__ } \
    default: return (int)cudaErrorInvalidValue;       \
  }

}  // namespace lc
