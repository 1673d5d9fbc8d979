// The decode kernels at MLA's latent shapes (deepseek-v2's absorbed decode:
// one key/value head of D = kv_lora + rope = 576, G = 128 query heads in
// f32; 48 and 4 at SMOKE size), on the latent core (latent_core.cuh):
//
//  * flash_decode_latent: replaces src/repro/kernels/flash_decode.py,
//    flash_decode (pl.pallas_call at :125), at these shapes: the exact
//    path's whole latent cache and the self token, and the unfused op's
//    masked centroid pass.  Grid (chunks of S, head tiles, B * Hkv).
//  * block_gather_latent: replaces src/repro/kernels/
//    block_gather_attention.py, block_gather_attention (pl.pallas_call at
//    :255): the selected clusters (+), their centroids' stage-1 terms (-)
//    and the recent ring with the self token (+).  Grid (I clusters +
//    extras chunks, head tiles, B * Hkv).
//  * fused_synopsis_latent: replaces src/repro/kernels/fused_synopsis.py,
//    fused_synopsis_score_attention (pl.pallas_call at :139): the scores
//    (max over all G heads, crossing the head tiles through a scratch row
//    per tile and a ticket per (b, hkv)) and the count-biased partials.
//    Grid (chunks of M, head tiles, B * Hkv).
//  * synopsis_score_latent: replaces src/repro/kernels/synopsis_score.py,
//    synopsis_score (pl.pallas_call at :46): one block a (b, hkv) and 16
//    centroid rows, looping over the head tiles with each row's running
//    max; no cross-block reduction.
//
// What bounds them: operations, ~128 flops a byte of bf16 latent at G =
// 128 (flash_decode over (2, 1, 8192, 576): 37.7 MB, 4.83 GFLOP), done in
// f32 on the CUDA cores because the query is f32 (the reference's einsum
// prefers f32; rounding it to bf16 would be a different result).  q is
// f32; K, V, the extras and the tables are f32 or bf16 alike (TK); stage
// 2's decrement rows TK or f32.
#include "latent_core.cuh"

using lc::HT;
using lc::THREADS;

// K and V may be views: rows D apart, heads kv_sh and batches kv_sb
// elements apart.
template <typename TK, int D>
__global__ void __launch_bounds__(THREADS, 2) latent_flash_decode_kernel(
    const float* __restrict__ q, const TK* __restrict__ k,
    const TK* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part,
    unsigned* __restrict__ tickets, int Hkv, int G, int S, int chunk,
    int kv_sb, int kv_sh, float sm_scale, float cap) {
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int tile = blockIdx.y, ntiles = gridDim.y, bh = blockIdx.z;
  const int g0 = tile * HT + (threadIdx.x >> 5) * lc::HPW;
  const int s0 = split * chunk, n = min(S, s0 + chunk) - s0;
  lc::State<D> st;
  lc::load_q<D>(st, q + (size_t)bh * G * D, g0, G);
  const float* bb = bias == nullptr ? nullptr : bias + (size_t)bh * S + s0;
  const auto logit = [=](float raw, int r) {
    return softcap_f(raw * sm_scale, cap) + (bb == nullptr ? 0.f : bb[r]);
  };
  const size_t off = (size_t)(bh / Hkv) * kv_sb + (size_t)(bh % Hkv) * kv_sh +
                     (size_t)s0 * D;
  lc::stream<TK, D>(k + off, v + off, n, g0, G, smem, st, logit);
  lc::write_out<false, D>(st, g0, G, (size_t)bh * G, nsplit, split, o, m_out,
                          l_out, o_part, m_part, l_part);
  if (nsplit > 1)
    lc::merge_if_last<false, D>(tickets + bh * ntiles + tile, nsplit, G,
                                tile * HT, (size_t)bh * G, o_part, m_part,
                                l_part, o, m_out, l_out);
}

struct LatentGatherArgs {
  const float* q;
  const void* k;
  const void* v;
  const int* selected;
  const void* k_sel;
  const void* v_sel;
  const float* sel_bias;
  const void* ek;
  const void* ev;
  const float* eb;
  float* o;
  float* m;
  float* l;
  float* o_part;
  float* m_part;
  float* l_part;
  unsigned* tickets;  // (B * Hkv * head tiles) zeroed counters
  int Hkv, G, S, C, I, E, xrows;
  float sm_scale, cap;
  bool dec_f32;  // k_sel / v_sel in f32, else in TK
};

// One block a part (a selected cluster, blockIdx.x < I, or an extras
// chunk) and a head tile; blockIdx.z = b * Hkv + h.
template <typename TK, int D>
__global__ void __launch_bounds__(THREADS, 2)
    latent_gather_kernel(LatentGatherArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int part = blockIdx.x, nparts = gridDim.x;
  const int tile = blockIdx.y, ntiles = gridDim.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, G = a.G;
  const int g0 = tile * HT + (threadIdx.x >> 5) * lc::HPW;
  const float sm_scale = a.sm_scale, cap = a.cap;
  lc::State<D> st;
  lc::load_q<D>(st, a.q + (size_t)bh * G * D, g0, G);
  const bool cluster = part < a.I;
  bool valid = false;
  if (cluster) {
    const int sel = a.selected[(size_t)bh * a.I + part];
    valid = sel >= 0;
    const int cid = valid ? sel : 0;  // -1 reads cluster 0 (masked)
    const auto logit = [=](float raw, int) {
      return valid ? softcap_f(raw * sm_scale, cap) : NEG_INF_F;
    };
    const size_t off = ((size_t)bh * a.S + (size_t)cid * a.C) * D;
    lc::stream<TK, D>(reinterpret_cast<const TK*>(a.k) + off,
                      reinterpret_cast<const TK*>(a.v) + off, a.C, g0, G,
                      smem, st, logit);
  } else {  // a chunk of the recent ring + self-KV, validity in the bias
    const int x0 = (part - a.I) * a.xrows;
    const float* eb = a.eb + (size_t)b * a.E + x0;
    const auto logit = [=](float raw, int r) {
      return softcap_f(raw * sm_scale, cap) + eb[r];
    };
    const size_t off = ((size_t)bh * a.E + x0) * D;
    lc::stream<TK, D>(reinterpret_cast<const TK*>(a.ek) + off,
                      reinterpret_cast<const TK*>(a.ev) + off,
                      min(a.E - x0, a.xrows), g0, G, smem, st, logit);
  }
  if (cluster && a.k_sel != nullptr) {
    // The centroid's stage-1 term, as one row of weight -1.
    const size_t ci = (size_t)bh * a.I + part;
    float d[lc::HPW], dl[lc::HPW];
    lc::row_dots<TK, D>(st, a.dec_f32
        ? (const void*)(reinterpret_cast<const float*>(a.k_sel) + ci * D)
        : (const void*)(reinterpret_cast<const TK*>(a.k_sel) + ci * D),
        a.dec_f32, d);
#pragma unroll
    for (int h = 0; h < lc::HPW; ++h)
      dl[h] = valid ? softcap_f(d[h] * sm_scale, cap) + a.sel_bias[ci]
                    : NEG_INF_F;
    lc::fold_decrement<TK, D>(st, dl, a.dec_f32
        ? (const void*)(reinterpret_cast<const float*>(a.v_sel) + ci * D)
        : (const void*)(reinterpret_cast<const TK*>(a.v_sel) + ci * D),
        a.dec_f32);
  }
  lc::write_out<true, D>(st, g0, G, (size_t)bh * G, nparts, part, a.o, a.m,
                         a.l, a.o_part, a.m_part, a.l_part);
  if (nparts > 1)
    lc::merge_if_last<true, D>(a.tickets + bh * ntiles + tile, nparts, G,
                               tile * HT, (size_t)bh * G, a.o_part,
                               a.m_part, a.l_part, a.o, a.m, a.l);
}

struct LatentSynopsisArgs {
  const float* q;
  const void* k_syn;
  const void* v_syn;
  const float* cbias;   // (B, M)
  float* scores;        // (B, Hkv, M)
  float* score_part;    // (B * Hkv, head tiles, M) scratch
  float* o;
  float* m;
  float* l;
  float* o_part;
  float* m_part;
  float* l_part;
  unsigned* tickets;    // (B * Hkv * (head tiles + 1)) zeroed counters
  int Hkv, G, M, chunk;
  float sm_scale, cap;
};

template <typename TK, int D>
__global__ void __launch_bounds__(THREADS, 2)
    latent_synopsis_kernel(LatentSynopsisArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int tile = blockIdx.y, ntiles = gridDim.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, G = a.G, M = a.M;
  const int g0 = tile * HT + (threadIdx.x >> 5) * lc::HPW;
  const int s0 = split * a.chunk, n = min(M, s0 + a.chunk) - s0;
  const float sm_scale = a.sm_scale, cap = a.cap;
  lc::State<D> st;
  lc::load_q<D>(st, a.q + (size_t)bh * G * D, g0, G);
  const float* cb = a.cbias + (size_t)b * M + s0;
  const auto logit = [=](float raw, int r) {
    return softcap_f(raw * sm_scale, cap) + __ldg(cb + r);
  };
  const size_t row0 = (size_t)bh * M + s0;
  float* part_scores = a.score_part + ((size_t)bh * ntiles + tile) * M + s0;
  lc::stream<TK, D>(reinterpret_cast<const TK*>(a.k_syn) + row0 * D,
                    reinterpret_cast<const TK*>(a.v_syn) + row0 * D, n, g0,
                    G, smem, st, logit, part_scores, sm_scale);
  lc::write_out<false, D>(st, g0, G, (size_t)bh * G, nsplit, split, a.o,
                          a.m, a.l, a.o_part, a.m_part, a.l_part);
  if (nsplit > 1)
    lc::merge_if_last<false, D>(a.tickets + bh * ntiles + tile, nsplit, G,
                                tile * HT, (size_t)bh * G, a.o_part,
                                a.m_part, a.l_part, a.o, a.m, a.l);
  // The scores: the max over the head tiles' rows, by the (b, hkv)'s last
  // block.
  if (lc::last_ticket(a.tickets + gridDim.z * ntiles + bh, nsplit * ntiles))
    for (int r = threadIdx.x; r < M; r += THREADS) {
      float best = NEG_INF_F;
      for (int t = 0; t < ntiles; ++t)
        best = fmaxf(best,
                     __ldcg(a.score_part + ((size_t)bh * ntiles + t) * M + r));
      a.scores[(size_t)bh * M + r] = best;
    }
}

// One block a (b, hkv) row (blockIdx.y) and ROWS centroid rows (blockIdx.x).
template <typename TK, int D>
__global__ void __launch_bounds__(THREADS, 2) latent_score_kernel(
    const float* __restrict__ q, const TK* __restrict__ k_syn,
    float* __restrict__ scores, int G, int M, float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float sc_s[lc::WARPS * lc::ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, r0 = blockIdx.x * lc::ROWS;
  const TK* kb = k_syn + (size_t)bh * M * D;
  lc::issue_tile<TK, D>(smem, kb, nullptr, r0, M);
  dc::cp_async_commit();
  dc::cp_async_wait<0>();
  __syncthreads();
  float best = NEG_INF_F;
  lc::State<D> st;
  for (int t = 0; t * HT < G; ++t) {
    const int g0 = t * HT + warp * lc::HPW;
    lc::load_q<D>(st, q + (size_t)bh * G * D, g0, G);
    const float raw = lc::tile_dots<TK, D>(smem, st);
    if (g0 + lane / lc::ROWS < G) best = fmaxf(best, raw * sm_scale);
  }
  best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, lc::ROWS));
  if (lane < lc::ROWS) sc_s[warp * lc::ROWS + lane] = best;
  __syncthreads();
  if (threadIdx.x < lc::ROWS && r0 + threadIdx.x < M) {
    float b = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < lc::WARPS; ++w)
      b = fmaxf(b, sc_s[w * lc::ROWS + threadIdx.x]);
    scores[(size_t)bh * M + r0 + threadIdx.x] = b;
  }
}

template <typename TK>
static int fd_launch(const float* q, const void* k, const void* v,
                     const float* bias, float* o, float* m, float* l,
                     float* o_part, float* m_part, float* l_part,
                     unsigned* tickets, int B, int Hkv, int G, int S, int D,
                     int chunk, int kv_sb, int kv_sh, float sm_scale,
                     float cap, cudaStream_t stream) {
  const int nsplit = (S + chunk - 1) / chunk;
  const dim3 grid(nsplit, (G + HT - 1) / HT, B * Hkv);
  DISPATCH_LATENT_DIM(D, {
    constexpr int smem = lc::Geo<TK, kD>::SMEM;
    cudaError_t err = allow_smem(latent_flash_decode_kernel<TK, kD>, smem);
    if (err != cudaSuccess) return (int)err;
    latent_flash_decode_kernel<TK, kD><<<grid, THREADS, smem, stream>>>(
        q, (const TK*)k, (const TK*)v, bias, o, m, l, o_part, m_part, l_part,
        tickets, Hkv, G, S, chunk, kv_sb, kv_sh, sm_scale, cap);
    return (int)cudaGetLastError();
  })
}

// q f32 (B, Hkv * G, D); kv_dtype: 0 = float32, 1 = bfloat16 (k, v); bias
// (B, Hkv, S) or NULL; k and v share their strides (rows D apart, heads
// kv_sh, batches kv_sb elements).  o_part (B*H, nsplit, D), m_part /
// l_part (B*H, nsplit): scratch for nsplit = ceil(S / chunk) > 1, with
// tickets (B * Hkv * head tiles) zeroed counters the kernel leaves zeroed.
extern "C" int flash_decode_latent_launch(
    const float* q, const void* k, const void* v, const float* bias, float* o,
    float* m, float* l, float* o_part, float* m_part, float* l_part,
    unsigned* tickets, int B, int Hkv, int G, int S, int D, int chunk,
    int kv_sb, int kv_sh, float sm_scale, float cap, int kv_dtype,
    void* stream) {
  if (G < 1 || G > lc::GMAX || S < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_dtype == 1)
    return fd_launch<__nv_bfloat16>(q, k, v, bias, o, m, l, o_part, m_part,
                                    l_part, tickets, B, Hkv, G, S, D, chunk,
                                    kv_sb, kv_sh, sm_scale, cap, st);
  if (kv_dtype == 0)
    return fd_launch<float>(q, k, v, bias, o, m, l, o_part, m_part, l_part,
                            tickets, B, Hkv, G, S, D, chunk, kv_sb, kv_sh,
                            sm_scale, cap, st);
  return (int)cudaErrorInvalidValue;
}

template <typename TK>
static int bg_launch(const LatentGatherArgs& a, int B, int D,
                     cudaStream_t stream) {
  const int nx = a.ek != nullptr ? (a.E + a.xrows - 1) / a.xrows : 0;
  const dim3 grid(a.I + nx, (a.G + HT - 1) / HT, B * a.Hkv);
  DISPATCH_LATENT_DIM(D, {
    constexpr int smem = lc::Geo<TK, kD>::SMEM;
    cudaError_t err = allow_smem(latent_gather_kernel<TK, kD>, smem);
    if (err != cudaSuccess) return (int)err;
    latent_gather_kernel<TK, kD><<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  })
}

// q f32; kv_dtype: k / v / extras' type (0 = float32, 1 = bfloat16);
// dec_dtype: k_sel / v_sel's (kv_dtype's, or 0 = float32).  k_sel ==
// NULL: no decrement; ek == NULL: no extras, else ceil(E / xrows) chunks
// of xrows rows.  Outputs and scratch as flash_decode_latent_launch's,
// with nparts = I + extras chunks.
extern "C" int block_gather_latent_launch(
    const float* q, const void* k, const void* v, const int* selected,
    const void* k_sel, const void* v_sel, const float* sel_bias,
    const void* ek, const void* ev, const float* eb, float* o, float* m,
    float* l, float* o_part, float* m_part, float* l_part, unsigned* tickets,
    int B, int Hkv, int G, int S, int D, int C, int I, int E, int xrows,
    float sm_scale, float cap, int kv_dtype, int dec_dtype, void* stream) {
  if (G < 1 || G > lc::GMAX || C < 1 || S % C || I < 1 || xrows < 1 ||
      (k_sel != nullptr && dec_dtype != kv_dtype && dec_dtype != 0))
    return (int)cudaErrorInvalidValue;
  const LatentGatherArgs a{q, k, v, selected, k_sel, v_sel, sel_bias, ek,
                           ev, eb, o, m, l, o_part, m_part, l_part, tickets,
                           Hkv, G, S, C, I, E, xrows, sm_scale, cap,
                           dec_dtype == 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_dtype == 1) return bg_launch<__nv_bfloat16>(a, B, D, st);
  if (kv_dtype == 0) return bg_launch<float>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

template <typename TK>
static int fs_launch(const LatentSynopsisArgs& a, int B, int D,
                     cudaStream_t stream) {
  const dim3 grid((a.M + a.chunk - 1) / a.chunk, (a.G + HT - 1) / HT,
                  B * a.Hkv);
  DISPATCH_LATENT_DIM(D, {
    constexpr int smem = lc::Geo<TK, kD>::SMEM;
    cudaError_t err = allow_smem(latent_synopsis_kernel<TK, kD>, smem);
    if (err != cudaSuccess) return (int)err;
    latent_synopsis_kernel<TK, kD><<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  })
}

// q f32; kv_dtype: the tables' type (0 = float32, 1 = bfloat16).
// score_part (B * Hkv, head tiles, M) scratch; tickets (B * Hkv * (head
// tiles + 1)) zeroed counters the kernel leaves zeroed; o_part / m_part /
// l_part scratch for more than one chunk of M.
extern "C" int fused_synopsis_latent_launch(
    const float* q, const void* k_syn, const void* v_syn, const float* cbias,
    float* scores, float* score_part, float* o, float* m, float* l,
    float* o_part, float* m_part, float* l_part, unsigned* tickets, int B,
    int Hkv, int G, int M, int D, int chunk, float sm_scale, float cap,
    int kv_dtype, void* stream) {
  if (G < 1 || G > lc::GMAX || M < 1 || chunk < 1 || tickets == nullptr ||
      score_part == nullptr)
    return (int)cudaErrorInvalidValue;
  const LatentSynopsisArgs a{q, k_syn, v_syn, cbias, scores, score_part, o,
                             m, l, o_part, m_part, l_part, tickets, Hkv, G,
                             M, chunk, sm_scale, cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_dtype == 1) return fs_launch<__nv_bfloat16>(a, B, D, st);
  if (kv_dtype == 0) return fs_launch<float>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

template <typename TK>
static int sc_launch(const float* q, const void* k_syn, float* scores, int B,
                     int Hkv, int G, int M, int D, float sm_scale,
                     cudaStream_t stream) {
  const dim3 grid((M + lc::ROWS - 1) / lc::ROWS, B * Hkv);
  DISPATCH_LATENT_DIM(D, {
    constexpr int smem = lc::Geo<TK, kD>::KBYTES;
    cudaError_t err = allow_smem(latent_score_kernel<TK, kD>, smem);
    if (err != cudaSuccess) return (int)err;
    latent_score_kernel<TK, kD><<<grid, THREADS, smem, stream>>>(
        q, (const TK*)k_syn, scores, G, M, sm_scale);
    return (int)cudaGetLastError();
  })
}

// q f32 (B, Hkv * G, D); kv_dtype: k_syn's type (0 = float32, 1 =
// bfloat16); scores (B, Hkv, M) f32.
extern "C" int synopsis_score_latent_launch(const float* q,
                                            const void* k_syn, float* scores,
                                            int B, int Hkv, int G, int M,
                                            int D, float sm_scale,
                                            int kv_dtype, void* stream) {
  if (G < 1 || G > lc::GMAX || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_dtype == 1)
    return sc_launch<__nv_bfloat16>(q, k_syn, scores, B, Hkv, G, M, D,
                                    sm_scale, st);
  if (kv_dtype == 0)
    return sc_launch<float>(q, k_syn, scores, B, Hkv, G, M, D, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
