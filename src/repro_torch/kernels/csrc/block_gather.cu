// Stage 2 of AccuracyTrader decode: exact attention over the selected
// clusters' original tokens, with the fused decrement and extras epilogues.
//
// Replaces: src/repro/kernels/block_gather_attention.py,
// block_gather_attention (pl.pallas_call at :255, body _kernel at :52),
// with the decrement (k_sel/v_sel/sel_bias) and extras (recent ring +
// self-KV) inputs, unquantized.
//
// What bounds it on the H100: bytes.  Per (b, hkv) it reads I clusters of
// C rows of K and V (2 * I * C * D elements), I centroid rows and E extras
// rows, with ~2 flops per byte at G = 4.  The cache is cluster-contiguous,
// so a selected cluster is C consecutive rows: the block reads the
// selected ids itself (the scalar prefetch of the TPU kernel) and streams
// each cluster in 32-row tiles straight from device memory, never
// materialising a gathered copy.  Per selected cluster the centroid's
// stage-1 term is accumulated with weight -1 (decremental masking), then
// the extras rows with their (B, E) bias; E = 129 (128-row ring + self)
// leaves a ragged tail that is masked.  `-1` ids are clamped to cluster 0 and their logits set to
// the -1e30 sentinel, exactly as the Pallas kernel and the reference do:
// in the all-padded case (budget 0) their exp(0) = 1 terms are wiped out by
// the extras step's rescale, as there.
// The flush divides by l only where |l| > 1e-30 (l may cancel or go
// negative under the decrement).  One block per (b, hkv): 16 blocks at the
// slice's shape; splitting I across blocks is left to a later change.
#include "attn_common.cuh"

template <typename T>
__global__ void block_gather_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ selected, const T* __restrict__ k_sel,
    const T* __restrict__ v_sel, const float* __restrict__ sel_bias,
    const T* __restrict__ ek, const T* __restrict__ ev,
    const float* __restrict__ eb, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int G,
    int S, int D, int C, int I, int E, float sm_scale, float cap) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  SoftmaxSmem s = carve_smem(smem, G, D);

  const T* qb = q + (size_t)bh * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) s.q[i] = to_f(qb[i]);
  init_state(s, G, D);

  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  for (int i = 0; i < I; ++i) {
    const int sel = selected[(size_t)bh * I + i];
    const bool valid = sel >= 0;
    const size_t row0 = (size_t)(valid ? sel : 0) * C;

    if (k_sel != nullptr) {  // decrement: this centroid's stage-1 term, -1x
      const size_t ci = (size_t)bh * I + i;
      load_tile(s, k_sel + ci * D, v_sel + ci * D, 1, D, D);
      __syncthreads();
      tile_logits(s, G, 1, D, sm_scale);
      const float cb = sel_bias[ci];
      for (int t = threadIdx.x; t < G * TM; t += blockDim.x) {
        if (t % TM == 0)
          s.p[t] = valid ? softcap_f(s.p[t], cap) + cb : NEG_INF_F;
      }
      softmax_update(s, G, 1, D, -1.f);
    }
    for (int r0 = 0; r0 < C; r0 += TM) {
      const int n = min(TM, C - r0);
      load_tile(s, kb + (row0 + r0) * D, vb + (row0 + r0) * D, n, D, D);
      __syncthreads();
      tile_logits(s, G, n, D, sm_scale);
      for (int t = threadIdx.x; t < G * TM; t += blockDim.x) {
        if (t % TM < n) s.p[t] = valid ? softcap_f(s.p[t], cap) : NEG_INF_F;
      }
      softmax_update(s, G, n, D, 1.f);
    }
  }

  if (ek != nullptr) {  // recent ring + self-KV, validity in the bias
    const T* ekb = ek + (size_t)bh * E * D;
    const T* evb = ev + (size_t)bh * E * D;
    for (int r0 = 0; r0 < E; r0 += TM) {
      const int n = min(TM, E - r0);
      load_tile(s, ekb + (size_t)r0 * D, evb + (size_t)r0 * D, n, D, D);
      __syncthreads();
      tile_logits(s, G, n, D, sm_scale);
      for (int t = threadIdx.x; t < G * TM; t += blockDim.x) {
        const int j = t % TM;
        if (j < n) s.p[t] = softcap_f(s.p[t], cap) + eb[(size_t)b * E + r0 + j];
      }
      softmax_update(s, G, n, D, 1.f);
    }
  }

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const float l = s.l[i / D];
    o[(size_t)bh * G * D + i] = s.acc[i] / (fabsf(l) > 1e-30f ? l : 1.f);
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_out[(size_t)bh * G + g] = s.m[g];
    l_out[(size_t)bh * G + g] = s.l[g];
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const int* selected, const void* k_sel, const void* v_sel,
                  const float* sel_bias, const void* ek, const void* ev,
                  const float* eb, float* o, float* m, float* l, int B,
                  int Hkv, int G, int S, int D, int C, int I, int E,
                  float sm_scale, float cap, cudaStream_t stream) {
  const size_t smem = softmax_smem_floats(G, D) * sizeof(float);
  cudaError_t err = allow_smem(block_gather_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  block_gather_kernel<T><<<B * Hkv, 128, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, selected, (const T*)k_sel,
      (const T*)v_sel, sel_bias, (const T*)ek, (const T*)ev, eb, o, m, l, Hkv,
      G, S, D, C, I, E, sm_scale, cap);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, k_sel, v_sel, extras).
// k_sel == NULL: no decrement; ek == NULL: no extras.  cap <= 0: no softcap.
extern "C" int block_gather_launch(
    const void* q, const void* k, const void* v, const int* selected,
    const void* k_sel, const void* v_sel, const float* sel_bias,
    const void* ek, const void* ev, const float* eb, float* o, float* m,
    float* l, int B, int Hkv, int G, int S, int D, int C, int I, int E,
    float sm_scale, float cap, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, selected, k_sel, v_sel, sel_bias,
                                 ek, ev, eb, o, m, l, B, Hkv, G, S, D, C, I,
                                 E, sm_scale, cap, st);
  return launch<float>(q, k, v, selected, k_sel, v_sel, sel_bias, ek, ev, eb,
                       o, m, l, B, Hkv, G, S, D, C, I, E, sm_scale, cap, st);
}
