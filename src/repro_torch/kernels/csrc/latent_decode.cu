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
// What bounds them on the CUDA cores: operations, ~128 flops a byte of
// latent at G = 128 (flash_decode over (2, 1, 8192, 576): 37.7 MB in bf16,
// 4.83 GFLOP), done in f32 because the query is f32 (the reference's einsum
// prefers f32; rounding it to bf16 would be a different result).  q is
// f32; K, V, the extras and the tables are f32 or bf16 alike (TK); stage
// 2's decrement rows TK or f32.  The C entry points send flash_decode's
// bf16 rows, and block_gather's bf16 / int8 / fp8 cache beside bf16 extras
// (or none), to the tensor-core kernels of latent_mma.cuh instead; f32
// rows stay here.  Stage 1 and stage 2 also read a quantized
// arena's int8 / fp8 codes with their scales (latent_decode.cuh: the
// Pallas kernels' `has_scale` and `has_kq` branches; the extras and the
// decrement rows stay f32 / bf16), and stage 2 takes the fleet tier's row
// map; their kernels are templates in latent_decode.cuh, and this file
// holds the C entry points with the unquantized instantiations.
#include "latent_mma.cuh"

// The quantized instantiations of stage 1 and stage 2 (int8 / fp8 codes
// with their scales), compiled in latent_decode_int8.cu and
// latent_decode_fp8.cu.
#define LATENT_QUANT_EXTERN(TK)                                              \
  extern template int latent_gather_launch<TK, float>(                       \
      const LatentGatherArgs&, int, int, cudaStream_t);                      \
  extern template int latent_synopsis_launch<TK>(const LatentSynopsisArgs&,  \
                                                 int, int, cudaStream_t);
LATENT_QUANT_EXTERN(int8_t)
LATENT_QUANT_EXTERN(__nv_fp8_e4m3)
// The tensor-core stage 2, compiled in latent_mma{,_int8,_fp8}.cu.
extern template int lm::gather_launch<__nv_bfloat16>(const LatentGatherArgs&,
                                                     int, int, int,
                                                     cudaStream_t);
extern template int lm::gather_launch<int8_t>(const LatentGatherArgs&, int,
                                              int, int, cudaStream_t);
extern template int lm::gather_launch<__nv_fp8_e4m3>(const LatentGatherArgs&,
                                                     int, int, int,
                                                     cudaStream_t);

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

// q f32 (B, Hkv * G, D); kv_dtype: 0 = float32, 1 = bfloat16 (k, v);
// bias (B, Hkv, S) or NULL; k and v share their strides (rows D apart,
// heads kv_sh, batches kv_sb elements).  mma: 1 = the tensor-core kernel
// (bf16 rows), 0 = the CUDA cores' (f32 rows); the wrapper chooses, and
// sizes `chunk` for its choice.  o_part (B*H, nsplit, D), m_part / l_part
// (B*H, nsplit): scratch for nsplit = ceil(S / chunk) > 1, with (mma 0)
// tickets (B * Hkv * head tiles) zeroed counters the kernel leaves zeroed.
extern "C" int flash_decode_latent_launch(
    const float* q, const void* k, const void* v, const float* bias, float* o,
    float* m, float* l, float* o_part, float* m_part, float* l_part,
    unsigned* tickets, int B, int Hkv, int G, int S, int D, int chunk,
    int kv_sb, int kv_sh, float sm_scale, float cap, int kv_dtype, int mma,
    void* stream) {
  if (G < 1 || G > lc::GMAX || S < 1 || chunk < 1 ||
      kv_dtype != (mma ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mma)
    return lm::decode_launch(
        lm::DecodeArgs{q, bias, o, m, l, o_part, m_part, l_part, Hkv, G, S,
                       chunk, sm_scale, cap},
        k, v, B, D, kv_sb, kv_sh, st);
  return fd_launch<float>(q, k, v, bias, o, m, l, o_part, m_part, l_part,
                          tickets, B, Hkv, G, S, D, chunk, kv_sb, kv_sh,
                          sm_scale, cap, st);
}

// The CUDA cores' stage 2: an f32 cache, or int8 / fp8 codes beside f32
// extras.
static int bg_f32(const LatentGatherArgs& a, int B, int D, int storage,
                  cudaStream_t st) {
  if (storage == 0) return latent_gather_launch<float, float>(a, B, D, st);
  if (storage == 2) return latent_gather_launch<int8_t, float>(a, B, D, st);
  if (storage == 3)
    return latent_gather_launch<__nv_fp8_e4m3, float>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

// q f32; kv_dtype: the extras' type (0 = float32, 1 = bfloat16); storage:
// k / v's type (kv_dtype's, or 2 = int8, 3 = fp8 e4m3 codes with
// kv_k_scale / kv_v_scale (B, Hkv, S / C) f32); dec_dtype: k_sel / v_sel's
// (kv_dtype's, or 0 = float32; 0 with a quantized cache).  rows: (B) the
// cache row of each batch row in k / v's leading axis (of Bk rows), or
// NULL (the identity).  k_sel == NULL: no decrement; ek == NULL: no extras,
// else ceil(E / xrows) chunks of xrows rows.  Outputs and scratch as
// flash_decode_latent_launch's, with nparts = I + extras chunks.  mma: 1 =
// the tensor cores (a bf16, int8 or fp8 cache beside bf16 extras or none),
// 0 = the CUDA cores (f32 rows); the wrapper chooses, and sizes xrows for
// its choice.
extern "C" int block_gather_latent_launch(
    const float* q, const void* k, const void* v, const int* selected,
    const void* k_sel, const void* v_sel, const float* sel_bias,
    const void* ek, const void* ev, const float* eb, const float* kv_k_scale,
    const float* kv_v_scale, const int* rows, float* o, float* m, float* l,
    float* o_part, float* m_part, float* l_part, unsigned* tickets, int B,
    int Bk, int Hkv, int G, int S, int D, int C, int I, int E, int xrows,
    float sm_scale, float cap, int kv_dtype, int storage, int dec_dtype,
    int mma, void* stream) {
  const bool quant = storage >= 2;
  if (G < 1 || G > lc::GMAX || C < 1 || S % C || I < 1 || xrows < 1 ||
      quant != (kv_k_scale != nullptr && kv_v_scale != nullptr) ||
      (k_sel != nullptr && dec_dtype != 0 && (quant || dec_dtype != kv_dtype))
      || (ek != nullptr && kv_dtype != (mma ? 1 : 0)))
    return (int)cudaErrorInvalidValue;
  const LatentGatherArgs a{q, k, v, selected, k_sel, v_sel, sel_bias, ek,
                           ev, eb, kv_k_scale, kv_v_scale, rows, o, m, l,
                           o_part, m_part, l_part, tickets, Hkv, G, S, C, I,
                           E, xrows, sm_scale, cap, dec_dtype == 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (!mma) return bg_f32(a, B, D, storage, st);
  switch (storage) {
    case 1: return lm::gather_launch<__nv_bfloat16>(a, B, Bk, D, st);
    case 2: return lm::gather_launch<int8_t>(a, B, Bk, D, st);
    case 3: return lm::gather_launch<__nv_fp8_e4m3>(a, B, Bk, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q f32; kv_dtype: the tables' type (0 = float32, 1 = bfloat16, 2 = int8,
// 3 = fp8 e4m3 codes with k_scale / v_scale (B, Hkv, M) f32, else NULL).
// score_part (B * Hkv, head tiles, M) scratch; tickets (B * Hkv * (head
// tiles + 1)) zeroed counters the kernel leaves zeroed; o_part / m_part /
// l_part scratch for more than one chunk of M.
extern "C" int fused_synopsis_latent_launch(
    const float* q, const void* k_syn, const void* v_syn, const float* cbias,
    const float* k_scale, const float* v_scale, float* scores,
    float* score_part, float* o, float* m, float* l, float* o_part,
    float* m_part, float* l_part, unsigned* tickets, int B, int Hkv, int G,
    int M, int D, int chunk, float sm_scale, float cap, int kv_dtype,
    void* stream) {
  if (G < 1 || G > lc::GMAX || M < 1 || chunk < 1 || tickets == nullptr ||
      score_part == nullptr ||
      (kv_dtype >= 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const LatentSynopsisArgs a{q, k_syn, v_syn, cbias, k_scale, v_scale,
                             scores, score_part, o, m, l, o_part, m_part,
                             l_part, tickets, Hkv, G, M, chunk, sm_scale,
                             cap};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_dtype) {
    case 0: return latent_synopsis_launch<float>(a, B, D, st);
    case 1: return latent_synopsis_launch<__nv_bfloat16>(a, B, D, st);
    case 2: return latent_synopsis_launch<int8_t>(a, B, D, st);
    case 3: return latent_synopsis_launch<__nv_fp8_e4m3>(a, B, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
