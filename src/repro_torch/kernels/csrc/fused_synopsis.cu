// Stage 1 of AccuracyTrader decode: fused centroid scoring + count-biased
// synopsis attention, in one pass over k_syn / v_syn.
//
// Replaces: src/repro/kernels/fused_synopsis.py, fused_synopsis_score_attention
// (pl.pallas_call at :139, body _kernel at :41), with its quantized branch
// (`has_scale`, :45, :63-66, :85): int8 / fp8 tables with one f32 scale per
// centroid row, the k-scale on the raw logits before sm_scale, the v-scale
// on p entering p.V (l unscaled).  The codes widen to f32 as the tile is
// staged; no dequantized table lands in device memory.
//
// What bounds it on the H100: bytes.  Per (b, hkv) the kernel reads M
// centroid rows of K and V once (2 * M * D elements) and does 4 * G * M * D
// flops; at G = 4 that is ~2 flops per byte in bf16, far below the ~295
// the tensor cores need, so the floor is the HBM read of the tables.  The
// design reads each centroid row from device memory exactly once, computes
// its G logits once and uses them twice (the group-max scores for top-k,
// and the softcapped, log(count)-biased online softmax), and keeps the
// (G, D) accumulator in shared memory.  The Pallas sequential M axis is a
// loop inside the block; the ragged tail of M (65 after one absorb) is
// masked, not padded.  One block per (b, hkv): only B * Hkv = 16 blocks at
// the slice's shape, so the kernel cannot fill 132 SMs — a split-M pass
// with a partials merge is the fix, left to a later change.
#include "attn_common.cuh"

// T: the query's type; TK: the tables' (T, int8 or fp8 with scales).
template <typename T, typename TK>
__global__ void fused_synopsis_kernel(const T* __restrict__ q,
                                      const TK* __restrict__ k_syn,
                                      const TK* __restrict__ v_syn,
                                      const float* __restrict__ cbias,
                                      const float* __restrict__ k_scale,
                                      const float* __restrict__ v_scale,
                                      float* __restrict__ scores,
                                      float* __restrict__ o,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out, int Hkv,
                                      int G, int M, int D, float sm_scale,
                                      float cap) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  SoftmaxSmem s = carve_smem(smem, G, D);

  const T* qb = q + (size_t)bh * G * D;  // heads h*G .. h*G+G-1 of batch b
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) s.q[i] = to_f(qb[i]);
  init_state(s, G, D);

  const TK* kb = k_syn + (size_t)bh * M * D;
  const TK* vb = v_syn + (size_t)bh * M * D;
  for (int m0 = 0; m0 < M; m0 += TM) {
    const int n = min(TM, M - m0);
    const size_t sc0 = (size_t)bh * M + m0;  // this tile's first scale
    load_tile(s, kb + (size_t)m0 * D, vb + (size_t)m0 * D, n, D, D);
    __syncthreads();
    tile_logits(s, G, n, D, sm_scale, k_scale ? k_scale + sc0 : nullptr);
    __syncthreads();
    // Use 1: correlation scores, max over the group, uncapped.  Use 2:
    // softcap + log(count) bias, in place, for the softmax update.
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float best = NEG_INF_F;
      const float cb = cbias[(size_t)b * M + m0 + j];
      for (int g = 0; g < G; ++g) {
        float x = s.p[g * TM + j];
        best = fmaxf(best, x);
        s.p[g * TM + j] = softcap_f(x, cap) + cb;
      }
      scores[(size_t)bh * M + m0 + j] = best;
    }
    softmax_update(s, G, n, D, 1.f, v_scale ? v_scale + sc0 : nullptr);
  }

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    o[(size_t)bh * G * D + i] = s.acc[i] / fmaxf(s.l[g], 1e-30f);
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_out[(size_t)bh * G + g] = s.m[g];
    l_out[(size_t)bh * G + g] = s.l[g];
  }
}

template <typename T, typename TK>
static int launch(const void* q, const void* k_syn, const void* v_syn,
                  const float* cbias, const float* k_scale,
                  const float* v_scale, float* scores, float* o, float* m,
                  float* l, int B, int Hkv, int G, int M, int D,
                  float sm_scale, float cap, cudaStream_t stream) {
  const size_t smem = softmax_smem_floats(G, D) * sizeof(float);
  cudaError_t err = allow_smem(fused_synopsis_kernel<T, TK>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_synopsis_kernel<T, TK><<<B * Hkv, 128, smem, stream>>>(
      (const T*)q, (const TK*)k_syn, (const TK*)v_syn, cbias, k_scale,
      v_scale, scores, o, m, l, Hkv, G, M, D, sm_scale, cap);
  return (int)cudaGetLastError();
}

// storage: the tables' type, the query's (dtype) or 2 = int8, 3 = fp8.
template <typename T>
static int launch_storage(int storage, int dtype, const void* q,
                          const void* k_syn, const void* v_syn,
                          const float* cbias, const float* k_scale,
                          const float* v_scale, float* scores, float* o,
                          float* m, float* l, int B, int Hkv, int G, int M,
                          int D, float sm_scale, float cap,
                          cudaStream_t st) {
#define FS_ARGS q, k_syn, v_syn, cbias, k_scale, v_scale, scores, o, m, l, \
                B, Hkv, G, M, D, sm_scale, cap, st
  if (storage == dtype) return launch<T, T>(FS_ARGS);
  if (storage == 2) return launch<T, int8_t>(FS_ARGS);
  if (storage == 3) return launch<T, __nv_fp8_e4m3>(FS_ARGS);
#undef FS_ARGS
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q); storage: the tables' type (0, 1,
// or 2 = int8, 3 = fp8 with k_scale / v_scale (B, Hkv, M) f32; NULL scales
// with unquantized tables); cap <= 0: no softcap.
extern "C" int fused_synopsis_launch(const void* q, const void* k_syn,
                                     const void* v_syn, const float* cbias,
                                     const float* k_scale,
                                     const float* v_scale, float* scores,
                                     float* o, float* m, float* l, int B,
                                     int Hkv, int G, int M, int D,
                                     float sm_scale, float cap, int dtype,
                                     int storage, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_storage<__nv_bfloat16>(storage, dtype, q, k_syn, v_syn,
                                         cbias, k_scale, v_scale, scores, o,
                                         m, l, B, Hkv, G, M, D, sm_scale,
                                         cap, st);
  if (dtype == 0)
    return launch_storage<float>(storage, dtype, q, k_syn, v_syn, cbias,
                                 k_scale, v_scale, scores, o, m, l, B, Hkv,
                                 G, M, D, sm_scale, cap, st);
  return (int)cudaErrorInvalidValue;
}
