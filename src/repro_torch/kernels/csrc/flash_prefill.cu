// Causal GQA prefill attention (flash style), with optional softcap and
// sliding window.
//
// Replaces: src/repro/kernels/flash_prefill.py, flash_prefill
// (pl.pallas_call at :140, body _kernel at :40).
//
// What bounds it on the H100: operations.  Causal attention over S = 8192
// does ~2 * 2 * S^2 / 2 * D flops per query head against 2 * S * D bytes
// of K/V per kv head — thousands of flops per byte, far above the ~295 of
// the tensor cores in bf16.  This first kernel runs those flops on CUDA
// cores in f32 (no wgmma yet), so it sits far below the tensor-core bound;
// wgmma tiles with TMA-fed K/V are the next step for it.  Layout: one block
// per (b, hkv, query tile of BQ positions); the tile's BQ * G query rows
// (the GQA group shares one K/V stream, as the Pallas kernel flattens
// (block_q, G) into one matmul) stay in shared memory with their f32
// accumulators.  The KV loop is bounded by the causal frontier of the tile
// (and by the window's start), so fully masked future blocks are never
// visited — the loop bound replaces the Pallas pl.when skip.  Masked
// logits inside a visited tile take the -1e30 sentinel as in the Pallas
// kernel; query rows past S are computed on zeros and never written.
#include "attn_common.cuh"

template <typename T>
__global__ void flash_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     T* __restrict__ out, int S, int H,
                                     int Hkv, int D, int BQ, float sm_scale,
                                     float cap, int window) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int R = BQ * G;
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int q0 = blockIdx.y * BQ;
  SoftmaxSmem s = carve_smem(smem, R, D);

  // Row r <-> (query position q0 + r / G, head h * G + r % G).
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r / G;
    float x = 0.f;
    if (qpos < S)
      x = to_f(q[(((size_t)b * S + qpos) * H + h * G + r % G) * D + d]);
    s.q[i] = x;
  }
  init_state(s, R, D);

  const int kv_hi = min(S, q0 + BQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const long long row_stride = (long long)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + h) * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D;
  for (int k0 = kv_lo; k0 < kv_hi; k0 += TM) {
    const int n = min(TM, kv_hi - k0);
    load_tile(s, kb + (size_t)k0 * row_stride, vb + (size_t)k0 * row_stride,
              n, D, row_stride);
    __syncthreads();
    tile_logits(s, R, n, D, sm_scale);
    for (int t = threadIdx.x; t < R * TM; t += blockDim.x) {
      const int r = t / TM, j = t % TM;
      if (j < n) {
        const int qpos = q0 + r / G, kpos = k0 + j;
        bool ok = kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        s.p[t] = ok ? softcap_f(s.p[t], cap) : NEG_INF_F;
      }
    }
    softmax_update(s, R, n, D, 1.f);
  }

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r / G;
    if (qpos < S)
      out[(((size_t)b * S + qpos) * H + h * G + r % G) * D + d] =
          from_f<T>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int Hkv, int D, float sm_scale,
                  float cap, int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const int BQ = G >= 64 ? 1 : 64 / G;  // 64 query rows per block
  const size_t smem = softmax_smem_floats(BQ * G, D) * sizeof(float);
  cudaError_t err = allow_smem(flash_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, (S + BQ - 1) / BQ);
  flash_prefill_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, Hkv, D, BQ,
      sm_scale, cap, window);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  cap <= 0: no softcap; window <= 0:
// no sliding window.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int Hkv, int D, float sm_scale,
                                    float cap, int window, int dtype,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, D, sm_scale, cap,
                                 window, st);
  return launch<float>(q, k, v, out, B, S, H, Hkv, D, sm_scale, cap, window,
                       st);
}
