// Synopsis build: permute the exact cache into cluster-contiguous order
// and aggregate each C-row cluster into its mean centroid, in one pass.
//
// Replaces: src/repro/kernels/synopsis_build.py, segment_build
// (pl.pallas_call at :173, body _kernel at :41), unquantized.  The same
// kernel runs the absorb of the recent ring with the identity permutation.
//
// What bounds it on the H100: bytes.  It reads every cache row once and
// writes it once (sorted K and V), plus M centroid rows: no arithmetic to
// speak of.  One block per (n, hkv, m) walks the cluster's C source rows
// perm[n, m*C + c] in order, threads across D (coalesced row reads and
// writes), and keeps the f32 centroid sum in registers; at the end it
// writes sum * (1/C) in the input type, as the Pallas flush does.  The
// Pallas grid axis over c (one row per step, double-buffered DMA) becomes
// the loop; the 32768 blocks of the slice's build keep the card busy.
#include "attn_common.cuh"

template <typename T>
__global__ void segment_build_kernel(const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ perm,
                                     T* __restrict__ k_sorted,
                                     T* __restrict__ v_sorted,
                                     T* __restrict__ k_syn,
                                     T* __restrict__ v_syn,
                                     float* __restrict__ counts, int Hkv,
                                     int S, int M, int D, int C) {
  const int m = blockIdx.x % M;
  const int nh = blockIdx.x / M;  // n * Hkv + h
  const int n = nh / Hkv, h = nh % Hkv;
  const size_t base = (size_t)nh * S * D;
  const int* pn = perm + (size_t)n * S + (size_t)m * C;
  const float inv = 1.0f / (float)C;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float ka = 0.f, va = 0.f;
    for (int c = 0; c < C; ++c) {
      const size_t src = base + (size_t)pn[c] * D + d;
      const size_t dst = base + ((size_t)m * C + c) * D + d;
      const T kx = k[src], vx = v[src];
      k_sorted[dst] = kx;
      v_sorted[dst] = vx;
      ka += to_f(kx);
      va += to_f(vx);
    }
    const size_t o = ((size_t)nh * M + m) * D + d;
    k_syn[o] = from_f<T>(ka * inv);
    v_syn[o] = from_f<T>(va * inv);
  }
  if (h == 0 && threadIdx.x == 0) counts[(size_t)n * M + m] = (float)C;
}

template <typename T>
static int launch(const void* k, const void* v, const int* perm,
                  void* k_sorted, void* v_sorted, void* k_syn, void* v_syn,
                  float* counts, int N, int Hkv, int S, int D, int C,
                  cudaStream_t stream) {
  const int M = S / C;
  segment_build_kernel<T><<<N * Hkv * M, 128, 0, stream>>>(
      (const T*)k, (const T*)v, perm, (T*)k_sorted, (T*)v_sorted, (T*)k_syn,
      (T*)v_syn, counts, Hkv, S, M, D, C);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (k, v and every T output).
extern "C" int segment_build_launch(const void* k, const void* v,
                                    const int* perm, void* k_sorted,
                                    void* v_sorted, void* k_syn, void* v_syn,
                                    float* counts, int N, int Hkv, int S,
                                    int D, int C, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(k, v, perm, k_sorted, v_sorted, k_syn, v_syn,
                                 counts, N, Hkv, S, D, C, st);
  return launch<float>(k, v, perm, k_sorted, v_sorted, k_syn, v_syn, counts,
                       N, Hkv, S, D, C, st);
}
