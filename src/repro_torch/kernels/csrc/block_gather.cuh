// The stage-2 kernel of block_gather.cu (see the note there) and its
// launch, as templates over the compute type T (q, extras) and the cache
// type TK, instantiated in block_gather.cu (TK = T), block_gather_int8.cu
// and block_gather_fp8.cu.
#pragma once

#include "decode_core.cuh"

struct GatherArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* selected;
  const void* k_sel;
  const void* v_sel;
  const float* sel_bias;
  const void* ek;
  const void* ev;
  const float* eb;
  const float* kv_k_scale;  // (B, Hkv, M) when k / v are quantized
  const float* kv_v_scale;
  const int* rows;  // (B) cache row of each batch row in k / v, or NULL
  float* o;  // final outputs
  float* m;
  float* l;
  float* o_part;  // the parts' partials (more than one part)
  float* m_part;
  float* l_part;
  unsigned* tickets;  // (B * Hkv) zeroed counters of the last-block merge
  int B, Hkv, G, S, D, C, I, E, xrows;
  float sm_scale, cap;
  bool dec_f32;  // k_sel / v_sel in f32, else in T
};

// Element i of a decrement row: T or f32.
template <typename T>
__device__ __forceinline__ float dec_at(const void* p, bool f32, size_t i) {
  return f32 ? reinterpret_cast<const float*>(p)[i]
             : to_f(reinterpret_cast<const T*>(p)[i]);
}

// One block a part: a selected cluster (blockIdx.x < I) or an extras
// chunk; blockIdx.y = b * Hkv + h.
template <typename T, typename TK, int D, int GB>
__global__ void __launch_bounds__(dc::WARPS * 32)
    block_gather_kernel(GatherArgs a) {
  using Sm = dc::Smem<T, TK, D, GB>;
  extern __shared__ __align__(16) char smem[];
  __shared__ float dec_s[GB];
  const int part = blockIdx.x, nparts = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hkv;
  const int G = a.G, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float sm_scale = a.sm_scale, cap = a.cap;
  const T* qb = reinterpret_cast<const T*>(a.q) + (size_t)bh * G * D;

  dc::WarpState<GB> st;
  const bool cluster = part < a.I;
  bool valid = false;
  float vsc = 1.f;
  if (cluster) {
    const int sel = a.selected[(size_t)bh * a.I + part];
    valid = sel >= 0;
    const int cid = valid ? sel : 0;  // -1 reads cluster 0 (masked)
    const size_t sc = (size_t)bh * (a.S / a.C) + cid;
    const float ksc = a.kv_k_scale != nullptr ? a.kv_k_scale[sc] : 1.f;
    if (a.kv_v_scale != nullptr) vsc = a.kv_v_scale[sc];
    dc::stage_q<T, TK, D, GB>(qb, G, Sm::q_s(smem));
    __syncthreads();
    const auto logit = [=](float raw, int) {
      return valid ? softcap_f(raw * ksc * sm_scale, cap) : NEG_INF_F;
    };
    // The cluster's rows in the cache row that the row map names (the
    // fleet tier's selected replica lane), b itself without one.
    const int row = a.rows != nullptr ? a.rows[b] : b;
    const size_t off =
        (((size_t)row * a.Hkv + bh % a.Hkv) * a.S + (size_t)cid * a.C) * D;
    dc::stream_chunk<TK, D, GB>(reinterpret_cast<const TK*>(a.k) + off,
                                reinterpret_cast<const TK*>(a.v) + off, a.C,
                                G, Sm::q_s(smem), logit, Sm::ring(smem),
                                Sm::p_s(smem), st);
  } else {  // a chunk of the recent ring + self-KV, validity in the bias
    const int x0 = (part - a.I) * a.xrows;
    const float* eb = a.eb + (size_t)b * a.E + x0;
    dc::stage_q<T, T, D, GB>(qb, G, Sm::q_s(smem));
    __syncthreads();
    const auto logit = [=](float raw, int r) {
      return softcap_f(raw * sm_scale, cap) + eb[r];
    };
    const size_t off = ((size_t)bh * a.E + x0) * D;
    dc::stream_chunk<T, D, GB>(reinterpret_cast<const T*>(a.ek) + off,
                               reinterpret_cast<const T*>(a.ev) + off,
                               min(a.E - x0, a.xrows), G, Sm::q_s(smem),
                               logit, Sm::ring(smem), Sm::p_s(smem), st);
  }

  // The centroid's stage-1 term of a cluster block: one warp a head.
  const bool has_dec = cluster && a.k_sel != nullptr;
  const size_t ci = (size_t)bh * a.I + part;
  if (has_dec) {
    for (int g = warp; g < G; g += dc::WARPS) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(to_f(qb[g * D + d]),
                 dec_at<T>(a.k_sel, a.dec_f32, ci * D + d), s);
      s = warp_sum(s);
      if (lane == 0)
        dec_s[g] = valid ? softcap_f(s * sm_scale, cap) + a.sel_bias[ci]
                         : NEG_INF_F;
    }
  }
  dc::block_merge<D, GB>(st, G, smem, [&](int g, int d, float m, float l,
                                          float acc) {
    if (cluster) {
      acc *= vsc;
      if (has_dec) {  // the decrement as one row of weight -1
        const float sc = dec_s[g];
        const float m2 = fmaxf(m, sc);
        const float e1 = expf(m - m2), e2 = expf(sc - m2);
        l = l * e1 - e2;
        acc = acc * e1 - dec_at<T>(a.v_sel, a.dec_f32, ci * D + d) * e2;
        m = m2;
      }
    }
    const size_t row = (size_t)bh * G + g;
    if (nparts == 1) {
      a.o[row * D + d] = dc::normalise<true>(acc, l);
      if (d == 0) {
        a.m[row] = m;
        a.l[row] = l;
      }
    } else {
      const size_t prow = row * nparts + part;
      a.o_part[prow * D + d] = acc;
      if (d == 0) {
        a.m_part[prow] = m;
        a.l_part[prow] = l;
      }
    }
  });
  if (nparts > 1)
    dc::merge_if_last<true, D, GB>(
        a.tickets + bh, nparts, G, (size_t)bh * G, a.o_part, a.m_part,
        a.l_part, a.o, a.m, a.l, reinterpret_cast<float*>(smem),
        Sm::P_OFF / 4);
}

// Launch the parts' kernel (one part a selected cluster, one an extras
// chunk); the last block of each (b, hkv) row merges the parts.
template <typename T, typename TK>
int gather_launch(const GatherArgs& a, cudaStream_t stream) {
  const int nx = a.ek != nullptr ? (a.E + a.xrows - 1) / a.xrows : 0;
  const int nparts = a.I + nx;
  if (a.G < 1 || a.G > GMAX || a.C < 1 || a.S % a.C || a.xrows < 1 ||
      nparts < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nparts, a.B * a.Hkv);
  DISPATCH_HEAD_DIM(a.D, DISPATCH_HEAD_BUCKET(a.G, {
    constexpr int smem = dc::Smem<T, TK, kD, kGB>::BYTES;
    cudaError_t err = allow_smem(block_gather_kernel<T, TK, kD, kGB>, smem);
    if (err != cudaSuccess) return (int)err;
    block_gather_kernel<T, TK, kD, kGB>
        <<<grid, dc::WARPS * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }))
}
