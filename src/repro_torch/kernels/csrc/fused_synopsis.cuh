// The stage-1 kernel of fused_synopsis.cu (see the note there) and its
// launch, as templates over the query type T and the tables' type TK,
// instantiated in fused_synopsis.cu (TK = T), fused_synopsis_int8.cu and
// fused_synopsis_fp8.cu.
#pragma once

#include "decode_core.cuh"

struct SynopsisArgs {
  const void* q;
  const void* k_syn;
  const void* v_syn;
  const float* cbias;    // (B, M) log(count) bias
  const float* k_scale;  // (B, Hkv, M) when the tables are quantized
  const float* v_scale;
  float* scores;  // (B, Hkv, M)
  float* o;       // final outputs
  float* m;
  float* l;
  float* o_part;  // the chunks' partials (more than one chunk)
  float* m_part;
  float* l_part;
  unsigned* tickets;  // (B * Hkv) zeroed counters of the last-block merge
  int Hkv, G, M, chunk;
  float sm_scale, cap;
};

// One block a chunk of `chunk` centroid rows (blockIdx.x) of one (b, hkv)
// row (blockIdx.y).
template <typename T, typename TK, int D, int GB>
__global__ void __launch_bounds__(dc::WARPS * 32)
    fused_synopsis_kernel(SynopsisArgs a) {
  using Sm = dc::Smem<TK, TK, D, GB>;
  constexpr bool kScaled = Quant<TK>::enabled;
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y, b = bh / a.Hkv;
  const int G = a.G, M = a.M;
  const int s0 = split * a.chunk, n = min(M, s0 + a.chunk) - s0;
  const float sm_scale = a.sm_scale, cap = a.cap;

  dc::stage_q<T, TK, D, GB>(reinterpret_cast<const T*>(a.q) +
                                (size_t)bh * G * D,
                            G, Sm::q_s(smem));
  __syncthreads();
  const size_t row0 = (size_t)bh * M + s0;  // the chunk's first table row
  const float* cb = a.cbias + (size_t)b * M + s0;
  const float* ks = kScaled ? a.k_scale + row0 : nullptr;
  const float* vs = kScaled ? a.v_scale + row0 : nullptr;
  float* scores = a.scores + row0;
  // The scaled, uncapped logit: the k-scale on the raw dot before
  // sm_scale, as the Pallas kernel orders them.
  const auto scaled = [=](float raw, int r) {
    return kScaled ? raw * __ldg(ks + r) * sm_scale : raw * sm_scale;
  };
  const auto logit = [=](float raw, int r) {
    return softcap_f(scaled(raw, r), cap) + __ldg(cb + r);
  };
  // The group-max score of a row, over its G real heads.
  const auto on_row = [=](const float (&x)[GB], int r) {
    float best = NEG_INF_F;
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G) best = fmaxf(best, scaled(x[g], r));
    scores[r] = best;
  };
  dc::WarpState<GB> st;
  const size_t off = row0 * D;
  const TK* k = reinterpret_cast<const TK*>(a.k_syn) + off;
  const TK* v = reinterpret_cast<const TK*>(a.v_syn) + off;
  if constexpr (kScaled) {
    // The v-scale weighs p entering p.V; l stays unscaled.
    const auto pscale = [=](float p, int r) { return p * __ldg(vs + r); };
    dc::stream_chunk<TK, D, GB>(k, v, n, G, Sm::q_s(smem), logit,
                                Sm::ring(smem), Sm::p_s(smem), st, on_row,
                                pscale);
  } else {
    dc::stream_chunk<TK, D, GB>(k, v, n, G, Sm::q_s(smem), logit,
                                Sm::ring(smem), Sm::p_s(smem), st, on_row);
  }
  dc::block_merge<D, GB>(st, G, smem, [&](int g, int d, float m, float l,
                                          float acc) {
    // Final outputs with one chunk, else the chunk's partial.
    const size_t row = (size_t)bh * G + g;
    if (nsplit == 1) {
      a.o[row * D + d] = dc::normalise<false>(acc, l);
      if (d == 0) {
        a.m[row] = m;
        a.l[row] = l;
      }
    } else {
      const size_t prow = row * nsplit + split;
      a.o_part[prow * D + d] = acc;
      if (d == 0) {
        a.m_part[prow] = m;
        a.l_part[prow] = l;
      }
    }
  });
  if (nsplit > 1)
    dc::merge_if_last<false, D, GB>(
        a.tickets + bh, nsplit, G, (size_t)bh * G, a.o_part, a.m_part,
        a.l_part, a.o, a.m, a.l, reinterpret_cast<float*>(smem),
        Sm::P_OFF / 4);
}

// Launch the chunks' kernel over B * Hkv rows; the last block of each
// (b, hkv) row merges its chunks.
template <typename T, typename TK>
int synopsis_launch(const SynopsisArgs& a, int B, int D, cudaStream_t stream) {
  if (a.G < 1 || a.G > GMAX || a.M < 1 || a.chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (a.M + a.chunk - 1) / a.chunk;
  if (nsplit > 1 && (a.o_part == nullptr || a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, B * a.Hkv);
  DISPATCH_HEAD_DIM(D, DISPATCH_HEAD_BUCKET(a.G, {
    constexpr int smem = dc::Smem<TK, TK, kD, kGB>::BYTES;
    cudaError_t err = allow_smem(fused_synopsis_kernel<T, TK, kD, kGB>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_synopsis_kernel<T, TK, kD, kGB>
        <<<grid, dc::WARPS * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }))
}
