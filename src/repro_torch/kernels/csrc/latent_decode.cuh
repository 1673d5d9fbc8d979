// Stage 1 and stage 2 of the latent core (latent_decode.cu's note) and
// their launches, as templates over the row types: the cache / table type
// TK (f32, bf16, or a quantized arena's int8 / fp8 e4m3 codes) and stage
// 2's extras type TE (f32 or bf16; TK's own when TK is unquantized),
// instantiated in latent_decode.cu (unquantized), latent_decode_int8.cu and
// latent_decode_fp8.cu, so that the three compile side by side.
//
// The quantized branches (the Pallas kernels' `has_scale` and `has_kq`):
//  * stage 1 (src/repro/kernels/fused_synopsis.py:45, 63-66, 85): each
//    centroid row's k-scale multiplies its raw logit before sm_scale, for
//    the scores (max over heads, uncapped; the scale is >= 0 and the same
//    for every head, so it commutes with the cross-tile max) and the
//    logits alike; its v-scale weighs p entering p.V, and l stays
//    unscaled;
//  * stage 2 (src/repro/kernels/block_gather_attention.py:57, 86-90, 108):
//    one k-scale per selected cluster multiplies the block's logits after
//    the f32 dot of 576 products (never per element), and its v-scale the
//    block's accumulator once (every row of the block shares it, so this
//    is the sum of p * vsc * v); the decrement rows (dequantized to f32 by
//    ops.refine_stage2) and the extras (the ring and the self token) take
//    no scale.
//
// Stage 2 also takes an optional row map `rows` (B entries): the cache row
// of batch row b is rows[b] of k / v's leading axis (the fleet tier's
// selected replica lane of each shard, read in place); NULL is the
// identity.  The scales, the selection and the decrement rows stay
// indexed by b.
#pragma once

#include "latent_core.cuh"

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
  const float* kv_k_scale;  // (B, Hkv, S / C) when k / v are quantized
  const float* kv_v_scale;
  const int* rows;          // (B) cache row of each batch row, or NULL
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
template <typename TK, typename TE, int D>
__global__ void __launch_bounds__(lc::THREADS, 2)
    latent_gather_kernel(LatentGatherArgs a) {
  constexpr bool kScaled = Quant<TK>::enabled;
  extern __shared__ __align__(16) char smem[];
  const int part = blockIdx.x, nparts = gridDim.x;
  const int tile = blockIdx.y, ntiles = gridDim.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, G = a.G;
  const int g0 = tile * lc::HT + (threadIdx.x >> 5) * lc::HPW;
  const float sm_scale = a.sm_scale, cap = a.cap;
  lc::State<D> st;
  lc::load_q<D>(st, a.q + (size_t)bh * G * D, g0, G);
  const bool cluster = part < a.I;
  bool valid = false;
  if (cluster) {
    const int sel = a.selected[(size_t)bh * a.I + part];
    valid = sel >= 0;
    const int cid = valid ? sel : 0;  // -1 reads cluster 0 (masked)
    const size_t sc = (size_t)bh * (a.S / a.C) + cid;
    // The cluster's k-scale on the raw dot (1 when unquantized: exact).
    const float ksc = kScaled ? a.kv_k_scale[sc] : 1.f;
    const auto logit = [=](float raw, int) {
      return valid ? softcap_f(raw * ksc * sm_scale, cap) : NEG_INF_F;
    };
    const int row = a.rows != nullptr ? a.rows[b] : b;
    const size_t off =
        (((size_t)row * a.Hkv + bh % a.Hkv) * a.S + (size_t)cid * a.C) * D;
    lc::stream<TK, D>(reinterpret_cast<const TK*>(a.k) + off,
                      reinterpret_cast<const TK*>(a.v) + off, a.C, g0, G,
                      smem, st, logit);
    if constexpr (kScaled) {  // the block's v-scale, once on its sum
      const float vsc = a.kv_v_scale[sc];
#pragma unroll
      for (int h = 0; h < lc::HPW; ++h)
#pragma unroll
        for (int c = 0; c < lc::State<D>::NC; ++c) st.acc[h][c] *= vsc;
    }
  } else {  // a chunk of the recent ring + self-KV, validity in the bias
    const int x0 = (part - a.I) * a.xrows;
    const float* eb = a.eb + (size_t)b * a.E + x0;
    const auto logit = [=](float raw, int r) {
      return softcap_f(raw * sm_scale, cap) + eb[r];
    };
    const size_t off = ((size_t)bh * a.E + x0) * D;
    lc::stream<TE, D>(reinterpret_cast<const TE*>(a.ek) + off,
                      reinterpret_cast<const TE*>(a.ev) + off,
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
                               tile * lc::HT, (size_t)bh * G, a.o_part,
                               a.m_part, a.l_part, a.o, a.m, a.l);
}

struct LatentSynopsisArgs {
  const float* q;
  const void* k_syn;
  const void* v_syn;
  const float* cbias;   // (B, M)
  const float* k_scale;  // (B, Hkv, M) when the tables are quantized
  const float* v_scale;
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
__global__ void __launch_bounds__(lc::THREADS, 2)
    latent_synopsis_kernel(LatentSynopsisArgs a) {
  constexpr bool kScaled = Quant<TK>::enabled;
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int tile = blockIdx.y, ntiles = gridDim.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, G = a.G, M = a.M;
  const int g0 = tile * lc::HT + (threadIdx.x >> 5) * lc::HPW;
  const int s0 = split * a.chunk, n = min(M, s0 + a.chunk) - s0;
  const float sm_scale = a.sm_scale, cap = a.cap;
  lc::State<D> st;
  lc::load_q<D>(st, a.q + (size_t)bh * G * D, g0, G);
  const float* cb = a.cbias + (size_t)b * M + s0;
  const size_t row0 = (size_t)bh * M + s0;
  const float* ks = kScaled ? a.k_scale + row0 : nullptr;
  const float* vs = kScaled ? a.v_scale + row0 : nullptr;
  // The scaled, uncapped logit: the k-scale on the raw dot before
  // sm_scale, as the Pallas kernel orders them.
  const auto score = [=](float raw, int r) {
    return kScaled ? raw * __ldg(ks + r) * sm_scale : raw * sm_scale;
  };
  const auto logit = [=](float raw, int r) {
    return softcap_f(score(raw, r), cap) + __ldg(cb + r);
  };
  float* part_scores = a.score_part + ((size_t)bh * ntiles + tile) * M + s0;
  const TK* k = reinterpret_cast<const TK*>(a.k_syn) + row0 * D;
  const TK* v = reinterpret_cast<const TK*>(a.v_syn) + row0 * D;
  if constexpr (kScaled) {
    // The v-scale weighs p entering p.V; l stays unscaled.
    const auto pscale = [=](float p, int r) { return p * __ldg(vs + r); };
    lc::stream<TK, D>(k, v, n, g0, G, smem, st, logit, part_scores, score,
                      pscale);
  } else {
    lc::stream<TK, D>(k, v, n, g0, G, smem, st, logit, part_scores, score);
  }
  lc::write_out<false, D>(st, g0, G, (size_t)bh * G, nsplit, split, a.o,
                          a.m, a.l, a.o_part, a.m_part, a.l_part);
  if (nsplit > 1)
    lc::merge_if_last<false, D>(a.tickets + bh * ntiles + tile, nsplit, G,
                                tile * lc::HT, (size_t)bh * G, a.o_part,
                                a.m_part, a.l_part, a.o, a.m, a.l);
  // The scores: the max over the head tiles' rows, by the (b, hkv)'s last
  // block.
  if (lc::last_ticket(a.tickets + gridDim.z * ntiles + bh, nsplit * ntiles))
    for (int r = threadIdx.x; r < M; r += lc::THREADS) {
      float best = NEG_INF_F;
      for (int t = 0; t < ntiles; ++t)
        best = fmaxf(best,
                     __ldcg(a.score_part + ((size_t)bh * ntiles + t) * M + r));
      a.scores[(size_t)bh * M + r] = best;
    }
}

// Stage 2's launch: one part a selected cluster, one an extras chunk of
// xrows rows, each with every head tile.
template <typename TK, typename TE>
int latent_gather_launch(const LatentGatherArgs& a, int B, int D,
                         cudaStream_t stream) {
  const int nx = a.ek != nullptr ? (a.E + a.xrows - 1) / a.xrows : 0;
  const dim3 grid(a.I + nx, (a.G + lc::HT - 1) / lc::HT, B * a.Hkv);
  DISPATCH_LATENT_DIM(D, {
    constexpr int smem = lc::Geo<TK, kD>::SMEM > lc::Geo<TE, kD>::SMEM
                             ? lc::Geo<TK, kD>::SMEM
                             : lc::Geo<TE, kD>::SMEM;
    cudaError_t err = allow_smem(latent_gather_kernel<TK, TE, kD>, smem);
    if (err != cudaSuccess) return (int)err;
    latent_gather_kernel<TK, TE, kD><<<grid, lc::THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  })
}

// Stage 1's launch: chunks of M x head tiles x B * Hkv.
template <typename TK>
int latent_synopsis_launch(const LatentSynopsisArgs& a, int B, int D,
                           cudaStream_t stream) {
  const dim3 grid((a.M + a.chunk - 1) / a.chunk, (a.G + lc::HT - 1) / lc::HT,
                  B * a.Hkv);
  DISPATCH_LATENT_DIM(D, {
    constexpr int smem = lc::Geo<TK, kD>::SMEM;
    cudaError_t err = allow_smem(latent_synopsis_kernel<TK, kD>, smem);
    if (err != cudaSuccess) return (int)err;
    latent_synopsis_kernel<TK, kD><<<grid, lc::THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  })
}
