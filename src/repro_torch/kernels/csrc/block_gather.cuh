// The stage-2 kernel of block_gather.cu (see the note there) and its
// launch, as templates over the compute type T (q, extras), the cache
// type TK and the stream (Core: decode_core.cuh's CUDA-core stream, or
// decode_mma.cuh's tensor-core one for bf16 rows in the head bucket of
// 16), instantiated in block_gather.cu (TK = T), block_gather_int8.cu and
// block_gather_fp8.cu.
#pragma once

#include "decode_mma.cuh"

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
  int mma;  // 1: the tensor-core stream, 0: the CUDA-core one
};

// Element i of a decrement row: T or f32.
template <typename T>
__device__ __forceinline__ float dec_at(const void* p, bool f32, size_t i) {
  return f32 ? reinterpret_cast<const float*>(p)[i]
             : to_f(reinterpret_cast<const T*>(p)[i]);
}

// One block a part: a selected cluster (blockIdx.x < I) or an extras
// chunk; blockIdx.y = b * Hkv + h.
template <typename T, typename TK, int D, typename Core>
__global__ void __launch_bounds__(dc::WARPS * 32, Core::MIN_BLOCKS)
    block_gather_kernel(GatherArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float dec_s[Core::GB];
  __shared__ float dec_kv[2][D];  // a cluster's decrement rows, as f32
  const int part = blockIdx.x, nparts = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hkv;
  const int G = a.G, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float sm_scale = a.sm_scale, cap = a.cap;
  const T* qb = reinterpret_cast<const T*>(a.q) + (size_t)bh * G * D;

  typename Core::State st;
  const bool cluster = part < a.I;
  const bool has_dec = cluster && a.k_sel != nullptr;
  const size_t ci = (size_t)bh * a.I + part;
  bool valid = false;
  float vsc = 1.f;
  if (cluster) {
    const int sel = a.selected[(size_t)bh * a.I + part];
    valid = sel >= 0;
    const int cid = valid ? sel : 0;  // -1 reads cluster 0 (masked)
    const size_t sc = (size_t)bh * (a.S / a.C) + cid;
    const float ksc = a.kv_k_scale != nullptr ? a.kv_k_scale[sc] : 1.f;
    if (a.kv_v_scale != nullptr) vsc = a.kv_v_scale[sc];
    if (has_dec)  // read beside the query, used after the span
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        dec_kv[0][d] = dec_at<T>(a.k_sel, a.dec_f32, ci * D + d);
        dec_kv[1][d] = dec_at<T>(a.v_sel, a.dec_f32, ci * D + d);
      }
    Core::template stage<TK>(qb, G, smem);
    __syncthreads();
    const auto logit = [=](float raw, int) {
      return valid ? softcap_f(raw * ksc * sm_scale, cap) : NEG_INF_F;
    };
    // The cluster's rows in the cache row that the row map names (the
    // fleet tier's selected replica lane), b itself without one.
    const int row = a.rows != nullptr ? a.rows[b] : b;
    const size_t off =
        (((size_t)row * a.Hkv + bh % a.Hkv) * a.S + (size_t)cid * a.C) * D;
    Core::template stream<TK>(reinterpret_cast<const TK*>(a.k) + off,
                              reinterpret_cast<const TK*>(a.v) + off, a.C, G,
                              logit, smem, st);
  } else {  // a chunk of the recent ring + self-KV, validity in the bias
    const int x0 = (part - a.I) * a.xrows;
    const float* eb = a.eb + (size_t)b * a.E + x0;
    Core::template stage<T>(qb, G, smem);
    __syncthreads();
    const auto logit = [=](float raw, int r) {
      return softcap_f(raw * sm_scale, cap) + eb[r];
    };
    const size_t off = ((size_t)bh * a.E + x0) * D;
    Core::template stream<T>(reinterpret_cast<const T*>(a.ek) + off,
                             reinterpret_cast<const T*>(a.ev) + off,
                             min(a.E - x0, a.xrows), G, logit, smem, st);
  }

  // The centroid's stage-1 term of a cluster block: one warp a head.
  if (has_dec) {
    for (int g = warp; g < G; g += dc::WARPS) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(to_f(qb[g * D + d]), dec_kv[0][d], s);
      s = warp_sum(s);
      if (lane == 0)
        dec_s[g] = valid ? softcap_f(s * sm_scale, cap) + a.sel_bias[ci]
                         : NEG_INF_F;
    }
  }
  Core::merge(st, G, smem, [&](int g, int d, float m, float l, float acc) {
    if (cluster) {
      acc *= vsc;
      if (has_dec) {  // the decrement as one row of weight -1
        const float sc = dec_s[g];
        const float m2 = fmaxf(m, sc);
        const float e1 = expf(m - m2), e2 = expf(sc - m2);
        l = l * e1 - e2;
        acc = acc * e1 - dec_kv[1][d] * e2;
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
    dc::merge_if_last<true, D, Core::GB>(
        a.tickets + bh, nparts, G, (size_t)bh * G, a.o_part, a.m_part,
        a.l_part, a.o, a.m, a.l, reinterpret_cast<float*>(smem),
        Core::SCRATCH);
}

template <typename T, typename TK, int D, typename Core>
int gather_run(const GatherArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Core::SMEM;
  cudaError_t err = allow_smem(block_gather_kernel<T, TK, D, Core>, smem);
  if (err != cudaSuccess) return (int)err;
  block_gather_kernel<T, TK, D, Core>
      <<<grid, dc::WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch the parts' kernel (one part a selected cluster, one an extras
// chunk); the last block of each (b, hkv) row merges the parts.  mma = 1:
// the tensor-core stream, for bf16 q, cache and extras, with one ring slot
// a team of warps (two measured slower over a cluster of 128 rows, PERF.md
// §6); 0: the CUDA-core stream, which is not built for them in the head
// bucket of 16 (those calls take the tensor cores).
template <typename T, typename TK>
int gather_launch(const GatherArgs& a, cudaStream_t stream) {
  const int nx = a.ek != nullptr ? (a.E + a.xrows - 1) / a.xrows : 0;
  const int nparts = a.I + nx;
  if (a.G < 1 || a.G > GMAX || a.C < 1 || a.S % a.C || a.xrows < 1 ||
      nparts < 1)
    return (int)cudaErrorInvalidValue;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value &&
                         std::is_same<TK, __nv_bfloat16>::value;
  const dim3 grid(nparts, a.B * a.Hkv);
  DISPATCH_HEAD_DIM(a.D, {
    if constexpr (kBf16) {
      if (a.mma == 1)
        return gather_run<T, TK, kD, dm::Core<kD, 1>>(a, grid, stream);
    }
    if (a.mma != 0) return (int)cudaErrorInvalidValue;
    DISPATCH_HEAD_BUCKET(a.G, {
      if constexpr (kBf16 && kGB == 16)
        return (int)cudaErrorInvalidValue;
      else
        return gather_run<T, TK, kD, dc::CudaCore<T, TK, kD, kGB>>(a, grid,
                                                                   stream);
    })
  })
}
