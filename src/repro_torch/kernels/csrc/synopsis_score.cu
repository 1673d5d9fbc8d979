// Per-cluster correlation scores of the unfused synopsis op: the max over
// the GQA group's G query heads of the centroid logit, (B, Hkv, M) f32.
//
// Replaces: src/repro/kernels/synopsis_score.py, synopsis_score
// (pl.pallas_call at :46, body _kernel at :20).  Like the Pallas kernel it
// scales each logit by sm_scale before the max (the reference scales the
// max; for sm_scale > 0 the two are the same number).
//
// What bounds it on the H100: bytes, and in practice the launch.  At the
// decode shape (B = 2, Hkv = 8, M = 64 or 65, D = 128, bf16) it reads
// ~0.26 MB of centroid keys (a ~0.08 us floor) and does 2 flops per byte.
// One thread owns one centroid row: it reads the row once in 16-byte
// vectors and dots it with the G query rows staged in shared memory, so
// the grid is (ceil(M / 128), B * Hkv) blocks of 128 threads and a ragged
// M (65 after an absorb) only leaves threads idle.
#include "attn_common.cuh"

constexpr int SS_THREADS = 128;

template <typename T, int D>
__global__ void __launch_bounds__(SS_THREADS) synopsis_score_kernel(
    const T* __restrict__ q, const T* __restrict__ k_syn,
    float* __restrict__ scores, int G, int M, float sm_scale) {
  __shared__ __align__(16) float q_s[GMAX * D];
  const int bh = blockIdx.y;  // b * Hkv + h
  const T* qb = q + (size_t)bh * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) q_s[i] = to_f(qb[i]);
  __syncthreads();
  const int mi = blockIdx.x * SS_THREADS + threadIdx.x;
  if (mi >= M) return;
  float s[GMAX];
  row_dots<T, D>(q_s, k_syn + ((size_t)bh * M + mi) * D, G, s);
  float best = s[0] * sm_scale;
#pragma unroll
  for (int g = 1; g < GMAX; ++g)
    if (g < G) best = fmaxf(best, s[g] * sm_scale);
  scores[(size_t)bh * M + mi] = best;
}

template <typename T>
static int launch(const void* q, const void* k_syn, float* scores, int B,
                  int Hkv, int G, int M, int D, float sm_scale,
                  cudaStream_t stream) {
  if (G < 1 || G > GMAX || M < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + SS_THREADS - 1) / SS_THREADS, B * Hkv);
  DISPATCH_HEAD_DIM(D, {
    synopsis_score_kernel<T, kD><<<grid, SS_THREADS, 0, stream>>>(
        (const T*)q, (const T*)k_syn, scores, G, M, sm_scale);
    return (int)cudaGetLastError();
  })
}

// dtype: 0 = float32, 1 = bfloat16 (q, k_syn).
extern "C" int synopsis_score_launch(const void* q, const void* k_syn,
                                     float* scores, int B, int Hkv, int G,
                                     int M, int D, float sm_scale, int dtype,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_syn, scores, B, Hkv, G, M, D,
                                 sm_scale, st);
  return launch<float>(q, k_syn, scores, B, Hkv, G, M, D, sm_scale, st);
}
