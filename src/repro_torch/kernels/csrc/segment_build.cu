// Synopsis build: permute the exact cache into cluster-contiguous order
// and aggregate each C-row cluster into its mean centroid, in one pass;
// optionally quantize the centroids and the sorted cache on the way out.
//
// Replaces: src/repro/kernels/synopsis_build.py, segment_build
// (pl.pallas_call at :173, body _kernel at :41), with its quantized flush
// (`quant` / `quant_kv`, :47-55, :65-67, :74-95).  The same kernel runs the
// absorb of the recent ring with the identity permutation.
//
// What bounds it on the H100: bytes.  It reads every cache row once and
// writes it once (sorted K and V), plus M centroid rows: no arithmetic to
// speak of.  One block per (n, hkv, m) walks the cluster's C source rows
// perm[n, m*C + c] in order, threads across D (coalesced row reads and
// writes), and keeps the f32 centroid sums; at the end it writes sum *
// (1/C), as the Pallas flush does.  The Pallas grid axis over c (one row per
// step, double-buffered DMA) becomes the loop; the 32768 blocks of the
// slice's build keep the card busy.
//
// Quantized (TS / TKV int8 or fp8-e4m3): the centroid row is quantized
// from its f32 mean with one scale per (n, h, m) row, which needs a
// block-wide amax over D after the mean (the means wait in shared memory).
// Under "+kv" the whole C x D sorted block shares one scale, so its amax
// must be known before any code is written: the first pass takes the amax
// while it sums, and a second pass reads the C source rows again (they were
// just read, so from L2) and writes their codes.  No f32 sorted copy lands
// in device memory, as in the Pallas kernel, which buffers the block in
// VMEM.  The sorted codes depend on no sum, so they match the plain
// version bit for bit; a centroid code follows an f32 mean whose sum order
// differs from torch's, and may sit one step away where the two means
// differ in their last bit.
#include "attn_common.cuh"

struct BuildArgs {
  const void* k;
  const void* v;
  const int* perm;
  void* k_sorted;
  void* v_sorted;
  void* k_syn;
  void* v_syn;
  float* counts;
  float* k_syn_scale;  // (N, Hkv, M) when the centroids are quantized
  float* v_syn_scale;
  float* k_scale;      // (N, Hkv, M) when the sorted cache is quantized
  float* v_scale;
  int N, Hkv, S, D, C;
};

constexpr int BUILD_THREADS = 128;

// Block-wide max of 4 values per thread (all threads get the result).
__device__ inline void block_max4(float (&x)[4], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = 0; i < 4; ++i) {
    x[i] = warp_max(x[i]);
    if (lane == 0) scratch[i * nwarps + warp] = x[i];
  }
  __syncthreads();
  for (int i = 0; i < 4; ++i) {
    float m = 0.f;
    for (int w = 0; w < nwarps; ++w) m = fmaxf(m, scratch[i * nwarps + w]);
    x[i] = m;
  }
}

// T: the cache's type; TS: the centroids' (T, or a quantized type); TKV:
// the sorted cache's (T, or TS under "+kv").
template <typename T, typename TS, typename TKV>
__global__ void segment_build_kernel(BuildArgs a, int M) {
  constexpr bool QS = Quant<TS>::enabled, QKV = Quant<TKV>::enabled;
  extern __shared__ float smem[];  // k mean (D), v mean (D), scratch
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  TKV* k_sorted = (TKV*)a.k_sorted;
  TKV* v_sorted = (TKV*)a.v_sorted;
  const int D = a.D, C = a.C;
  const int m = blockIdx.x % M;
  const int nh = blockIdx.x / M;  // n * Hkv + h
  const int n = nh / a.Hkv, h = nh % a.Hkv;
  const size_t base = (size_t)nh * a.S * D;
  const int* pn = a.perm + (size_t)n * a.S + (size_t)m * C;
  const float inv = 1.0f / (float)C;
  const size_t o = ((size_t)nh * M + m) * D;
  // amax of |k mean|, |v mean|, |k block|, |v block| over this thread's d
  float amax[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float ka = 0.f, va = 0.f;
    for (int c = 0; c < C; ++c) {
      const size_t src = base + (size_t)pn[c] * D + d;
      const T kx = k[src], vx = v[src];
      if constexpr (QKV) {
        amax[2] = fmaxf(amax[2], fabsf(to_f(kx)));
        amax[3] = fmaxf(amax[3], fabsf(to_f(vx)));
      } else {
        const size_t dst = base + ((size_t)m * C + c) * D + d;
        k_sorted[dst] = kx;
        v_sorted[dst] = vx;
      }
      ka += to_f(kx);
      va += to_f(vx);
    }
    if constexpr (QS) {
      smem[d] = ka * inv;
      smem[D + d] = va * inv;
      amax[0] = fmaxf(amax[0], fabsf(ka * inv));
      amax[1] = fmaxf(amax[1], fabsf(va * inv));
    } else {
      ((TS*)a.k_syn)[o + d] = from_f<TS>(ka * inv);
      ((TS*)a.v_syn)[o + d] = from_f<TS>(va * inv);
    }
  }
  if (h == 0 && threadIdx.x == 0) a.counts[(size_t)n * M + m] = (float)C;
  if constexpr (QS) {
    block_max4(amax, smem + 2 * D);  // syncs, so the means are visible
    const size_t so = (size_t)nh * M + m;
    const float qs = Quant<TS>::qmax, qkv = Quant<TKV>::qmax;
    float sc[4], iv[4];
    for (int i = 0; i < 4; ++i) {
      sc[i] = amax[i] / (i < 2 ? qs : qkv);
      iv[i] = inv_scale(sc[i]);
    }
    if (threadIdx.x == 0) {
      a.k_syn_scale[so] = sc[0];
      a.v_syn_scale[so] = sc[1];
      if constexpr (QKV) {
        a.k_scale[so] = sc[2];
        a.v_scale[so] = sc[3];
      }
    }
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      ((TS*)a.k_syn)[o + d] = Quant<TS>::encode(smem[d] * iv[0]);
      ((TS*)a.v_syn)[o + d] = Quant<TS>::encode(smem[D + d] * iv[1]);
    }
    if constexpr (QKV) {
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        for (int c = 0; c < C; ++c) {
          const size_t src = base + (size_t)pn[c] * D + d;
          const size_t dst = base + ((size_t)m * C + c) * D + d;
          k_sorted[dst] = Quant<TKV>::encode(to_f(k[src]) * iv[2]);
          v_sorted[dst] = Quant<TKV>::encode(to_f(v[src]) * iv[3]);
        }
      }
    }
  }
}

template <typename T, typename TS, typename TKV>
static int launch(const BuildArgs& a, cudaStream_t stream) {
  const int M = a.S / a.C;
  const size_t smem = (2 * (size_t)a.D + 4 * (BUILD_THREADS / 32)) *
                      sizeof(float);
  cudaError_t err = allow_smem(segment_build_kernel<T, TS, TKV>, smem);
  if (err != cudaSuccess) return (int)err;
  segment_build_kernel<T, TS, TKV>
      <<<a.N * a.Hkv * M, BUILD_THREADS, smem, stream>>>(a, M);
  return (int)cudaGetLastError();
}

// quant 0: none; 2: int8; 3: fp8 (quant_kv: the sorted cache too).
template <typename T>
static int launch_quant(const BuildArgs& a, int quant, int quant_kv,
                        cudaStream_t st) {
  if (quant == 0) return quant_kv ? (int)cudaErrorInvalidValue
                                  : launch<T, T, T>(a, st);
  if (quant == 2)
    return quant_kv ? launch<T, int8_t, int8_t>(a, st)
                    : launch<T, int8_t, T>(a, st);
  if (quant == 3)
    return quant_kv ? launch<T, __nv_fp8_e4m3, __nv_fp8_e4m3>(a, st)
                    : launch<T, __nv_fp8_e4m3, T>(a, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (k, v, and the unquantized outputs).
extern "C" int segment_build_launch(
    const void* k, const void* v, const int* perm, void* k_sorted,
    void* v_sorted, void* k_syn, void* v_syn, float* counts,
    float* k_syn_scale, float* v_syn_scale, float* k_scale, float* v_scale,
    int N, int Hkv, int S, int D, int C, int dtype, int quant, int quant_kv,
    void* stream) {
  const BuildArgs a{k, v, perm, k_sorted, v_sorted, k_syn, v_syn, counts,
                    k_syn_scale, v_syn_scale, k_scale, v_scale,
                    N, Hkv, S, D, C};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_quant<__nv_bfloat16>(a, quant, quant_kv, st);
  if (dtype == 0) return launch_quant<float>(a, quant, quant_kv, st);
  return (int)cudaErrorInvalidValue;
}
