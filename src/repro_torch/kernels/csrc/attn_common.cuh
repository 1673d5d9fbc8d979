// Shared device helpers for the port's hand-written Hopper kernels.
//
// All four kernels keep f32 online-softmax state (m, l, acc) in shared
// memory and accumulate on CUDA cores.  A tile of key/value rows is staged
// in shared memory as f32 with a padded row stride (D + 1), so that
// threads of one warp walking neighbouring rows hit distinct banks.
//
// NEG_INF_F is the finite sentinel of the JAX reference (-1e30): a masked
// logit is set to it and still takes part in the softmax, exactly as the
// Pallas kernels do, so a row that is all masked yields exp(0) = 1
// "garbage" that a later finite maximum wipes out (alpha = exp(-1e30 -
// m) = 0).  Rows past the end of a ragged tile are skipped instead: they do
// not exist in the reference at all.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// cap <= 0 means "no softcap".
__device__ __forceinline__ float softcap_f(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Tile of TM key/value rows; TM is the warp width so that one lane owns
// one row in the softmax update.
constexpr int TM = 32;

// Online-softmax state of R query rows of width D, all in shared memory.
struct SoftmaxSmem {
  float* q;    // (R, D)
  float* k;    // (TM, D + 1)
  float* v;    // (TM, D + 1)
  float* p;    // (R, TM) logits, then probabilities
  float* acc;  // (R, D)
  float* m;    // (R,)
  float* l;    // (R,)
  float* a;    // (R,) alpha of the last update
};

__host__ __device__ inline size_t softmax_smem_floats(int R, int D) {
  return (size_t)R * D * 2 + (size_t)TM * (D + 1) * 2 + (size_t)R * TM +
         (size_t)R * 3;
}

__device__ inline SoftmaxSmem carve_smem(float* base, int R, int D) {
  SoftmaxSmem s;
  s.q = base;
  s.acc = s.q + (size_t)R * D;
  s.k = s.acc + (size_t)R * D;
  s.v = s.k + (size_t)TM * (D + 1);
  s.p = s.v + (size_t)TM * (D + 1);
  s.m = s.p + (size_t)R * TM;
  s.l = s.m + R;
  s.a = s.l + R;
  return s;
}

__device__ inline void init_state(SoftmaxSmem s, int R, int D) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) s.acc[i] = 0.f;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s.m[i] = NEG_INF_F;
    s.l[i] = 0.f;
  }
}

// Stage n <= TM rows (row r at k + r * row_stride) as f32; rows >= n are
// zero.  Caller syncs before use.
template <typename T>
__device__ inline void load_tile(SoftmaxSmem s, const T* k, const T* v,
                                 int n, int D, long long row_stride) {
  for (int i = threadIdx.x; i < TM * D; i += blockDim.x) {
    int r = i / D, d = i % D;
    float kv = 0.f, vv = 0.f;
    if (r < n) {
      kv = to_f(k[r * row_stride + d]);
      vv = to_f(v[r * row_stride + d]);
    }
    s.k[r * (D + 1) + d] = kv;
    s.v[r * (D + 1) + d] = vv;
  }
}

// p[r, j] = q[r] . k[j] * sm_scale for the R x TM tile (rows j >= n are
// left unused).  One warp covers one query row, one lane one key row.
__device__ inline void tile_logits(SoftmaxSmem s, int R, int n, int D,
                                   float sm_scale) {
  for (int i = threadIdx.x; i < R * TM; i += blockDim.x) {
    int r = i / TM, j = i % TM;
    if (j < n) {
      const float* qr = s.q + (size_t)r * D;
      const float* kj = s.k + (size_t)j * (D + 1);
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kj[d], acc);
      s.p[i] = acc * sm_scale;
    }
  }
}

// One online-softmax step over the first n rows of the staged tile with
// the logits in s.p, accumulated with weight `sign` (+1, or -1 for the
// decremental centroid terms of stage 2).  Syncs internally; on return
// s.p holds free scratch again.
__device__ inline void softmax_update(SoftmaxSmem s, int R, int n, int D,
                                      float sign) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  for (int r = warp; r < R; r += nwarps) {
    float x = lane < n ? s.p[r * TM + lane] : NEG_INF_F;
    float m_prev = s.m[r];
    float m_new = fmaxf(m_prev, warp_max(x));
    float p = lane < n ? expf(x - m_new) : 0.f;
    float psum = warp_sum(p);
    s.p[r * TM + lane] = p;
    if (lane == 0) {
      float alpha = expf(m_prev - m_new);
      s.a[r] = alpha;
      s.l[r] = s.l[r] * alpha + sign * psum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    int r = i / D, d = i % D;
    const float* pr = s.p + (size_t)r * TM;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pr[j], s.v[j * (D + 1) + d], acc);
    s.acc[i] = s.acc[i] * s.a[r] + sign * acc;
  }
  __syncthreads();
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
