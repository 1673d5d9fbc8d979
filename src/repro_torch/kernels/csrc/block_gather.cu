// Stage 2 of AccuracyTrader decode: exact attention over the selected
// clusters' original tokens, with the fused decrement and extras epilogues.
//
// Replaces: src/repro/kernels/block_gather_attention.py,
// block_gather_attention (pl.pallas_call at :255, body _kernel at :52),
// with the decrement (k_sel/v_sel/sel_bias) and extras (recent ring +
// self-KV) inputs, and its quantized branch (`has_kq`, :57, :86-90, :108):
// int8 / fp8 sorted k / v with one f32 scale per cluster block, read
// through the same clamped id that picks the block (the Pallas
// `_scale_index`, :206-209), on the cluster's raw logits and on its p
// entering p.V; the decrement and the extras take no scale.  Under a
// quantized synopsis the decrement rows arrive dequantized in f32 while q
// and the extras keep the compute type, so k_sel / v_sel have a type of
// their own (TD).
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
  float* o;
  float* m;
  float* l;
  int B, Hkv, G, S, D, C, I, E;
  float sm_scale, cap;
};

// T: q and the extras; TK: the cache (T, int8 or fp8 with scales); TD: the
// decrement rows (T, or f32 under a quantized synopsis).
template <typename T, typename TK, typename TD>
__global__ void block_gather_kernel(GatherArgs a) {
  const T* __restrict__ q = (const T*)a.q;
  const TK* __restrict__ k = (const TK*)a.k;
  const TK* __restrict__ v = (const TK*)a.v;
  const int* __restrict__ selected = a.selected;
  const TD* __restrict__ k_sel = (const TD*)a.k_sel;
  const TD* __restrict__ v_sel = (const TD*)a.v_sel;
  const float* __restrict__ sel_bias = a.sel_bias;
  const T* __restrict__ ek = (const T*)a.ek;
  const T* __restrict__ ev = (const T*)a.ev;
  const float* __restrict__ eb = a.eb;
  float* __restrict__ o = a.o;
  float* __restrict__ m_out = a.m;
  float* __restrict__ l_out = a.l;
  const int Hkv = a.Hkv, G = a.G, S = a.S, D = a.D, C = a.C, I = a.I,
            E = a.E;
  const float sm_scale = a.sm_scale, cap = a.cap;
  const int M = S / C;
  extern __shared__ float smem[];
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  SoftmaxSmem s = carve_smem(smem, G, D);

  const T* qb = q + (size_t)bh * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) s.q[i] = to_f(qb[i]);
  init_state(s, G, D);

  const TK* kb = k + (size_t)bh * S * D;
  const TK* vb = v + (size_t)bh * S * D;
  for (int i = 0; i < I; ++i) {
    const int sel = selected[(size_t)bh * I + i];
    const bool valid = sel >= 0;
    const int cid = valid ? sel : 0;  // -1 reads cluster 0 (masked)
    const size_t row0 = (size_t)cid * C;
    // One scale for the whole cluster block (stride 0), or none.
    const float* ksc = a.kv_k_scale ? a.kv_k_scale + (size_t)bh * M + cid
                                    : nullptr;
    const float* vsc = a.kv_v_scale ? a.kv_v_scale + (size_t)bh * M + cid
                                    : nullptr;

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
      tile_logits(s, G, n, D, sm_scale, ksc, 0);
      for (int t = threadIdx.x; t < G * TM; t += blockDim.x) {
        if (t % TM < n) s.p[t] = valid ? softcap_f(s.p[t], cap) : NEG_INF_F;
      }
      softmax_update(s, G, n, D, 1.f, vsc, 0);
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

template <typename T, typename TK, typename TD>
static int launch(const GatherArgs& a, cudaStream_t stream) {
  const size_t smem = softmax_smem_floats(a.G, a.D) * sizeof(float);
  cudaError_t err = allow_smem(block_gather_kernel<T, TK, TD>, smem);
  if (err != cudaSuccess) return (int)err;
  block_gather_kernel<T, TK, TD><<<a.B * a.Hkv, 128, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The decrement rows' type: T's own, or f32 (dec_dtype 0).
template <typename T, typename TK>
static int launch_dec(const GatherArgs& a, int dtype, int dec_dtype,
                      cudaStream_t st) {
  if (dec_dtype == dtype) return launch<T, TK, T>(a, st);
  if (dec_dtype == 0) return launch<T, TK, float>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_storage(const GatherArgs& a, int dtype, int storage,
                          int dec_dtype, cudaStream_t st) {
  if (storage == dtype) return launch_dec<T, T>(a, dtype, dec_dtype, st);
  if (storage == 2) return launch_dec<T, int8_t>(a, dtype, dec_dtype, st);
  if (storage == 3)
    return launch_dec<T, __nv_fp8_e4m3>(a, dtype, dec_dtype, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, extras); storage: k / v's type (0,
// 1, or 2 = int8, 3 = fp8 with kv_k_scale / kv_v_scale (B, Hkv, M) f32;
// NULL scales with an unquantized cache); dec_dtype: k_sel / v_sel's type
// (dtype's, or 0 = float32).  k_sel == NULL: no decrement; ek == NULL: no
// extras.  cap <= 0: no softcap.
extern "C" int block_gather_launch(
    const void* q, const void* k, const void* v, const int* selected,
    const void* k_sel, const void* v_sel, const float* sel_bias,
    const void* ek, const void* ev, const float* eb, const float* kv_k_scale,
    const float* kv_v_scale, float* o, float* m, float* l, int B, int Hkv,
    int G, int S, int D, int C, int I, int E, float sm_scale, float cap,
    int dtype, int storage, int dec_dtype, void* stream) {
  const GatherArgs a{q, k, v, selected, k_sel, v_sel, sel_bias, ek, ev, eb,
                     kv_k_scale, kv_v_scale, o, m, l,
                     B, Hkv, G, S, D, C, I, E, sm_scale, cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_storage<__nv_bfloat16>(a, dtype, storage, dec_dtype, st);
  if (dtype == 0) return launch_storage<float>(a, dtype, storage, dec_dtype,
                                               st);
  return (int)cudaErrorInvalidValue;
}
