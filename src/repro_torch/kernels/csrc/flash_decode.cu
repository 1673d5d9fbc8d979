// GQA decode attention of one new query token over S keys, with an optional
// additive (B, Hkv, S) bias and softcap, returning f32 partials (o, m, l).
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (pl.pallas_call
// at :125, body _kernel at :29).  It serves the exact baseline (S = the
// whole cache, and S = 1 for the new token's self-KV) and the unfused
// synopsis op's stage 1 (S = M centroids, bias = log(count) or -1e30 for
// the selected clusters).
//
// What bounds it on the H100: bytes.  At the exact path's shape (B = 2,
// Hkv = 8, S = 8192, D = 128, G = 4, bf16) it reads 67 MB of K and V and
// does ~2 flops per byte, so the floor is the HBM read (~20 us).  The
// design is split-S: the grid is (S / chunk, B * Hkv), so the 16 (b, hkv)
// rows of the exact path become ~500 blocks that fill the 132 SMs, and a
// second small kernel merges the per-chunk partials (the TPU kernel's
// sequential S axis carried the state in VMEM scratch instead).  Inside a
// block every warp walks its own 32-row tiles with its softmax state in
// registers: lane j computes the G logits of key row j from 16-byte
// vector loads against the query group staged in shared memory (one
// broadcast per word), the warp takes the tile's max and sum with
// shuffles, and then each lane accumulates its D / 32 columns of p . V
// from coalesced row loads.  The four warps' states merge in shared
// memory at the end.  No tensor cores: at G = 4 a tile's products are far
// below the size at which they would pay.
//
// Masking follows the reference: a logit with the -1e30 bias enters the
// softmax like any other (an all-masked key set gives exp(0) = 1 per key,
// as the Pallas kernel does); rows past the end of S do not exist and are
// skipped.  m starts at the -1e30 sentinel, which is the reference's
// max(m, NEG_INF) clamp.  With one chunk (S <= 128 rows a block, e.g. the
// self token or the centroid tables) the first kernel writes the
// normalised output itself and the merge is not launched.
#include "attn_common.cuh"

constexpr int FD_WARPS = 4;

template <typename T, int D>
__global__ void __launch_bounds__(FD_WARPS * 32) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int G, int S, int chunk, float sm_scale,
    float cap) {
  constexpr int EPL = (D + 31) / 32;  // value columns per lane
  __shared__ __align__(16) float q_s[GMAX * D];
  __shared__ float p_s[FD_WARPS][GMAX][32];
  __shared__ float w_m[FD_WARPS][GMAX];
  __shared__ float w_l[FD_WARPS][GMAX];
  __shared__ float w_acc[FD_WARPS][GMAX * D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;  // b * Hkv + h
  const int s0 = split * chunk, s1 = min(S, s0 + chunk);

  const T* qb = q + (size_t)bh * G * D;  // heads h*G .. h*G+G-1 of batch b
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) q_s[i] = to_f(qb[i]);
  __syncthreads();

  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const float* bb = bias == nullptr ? nullptr : bias + (size_t)bh * S;

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  for (int r0 = s0 + warp * 32; r0 < s1; r0 += FD_WARPS * 32) {
    const int n = min(32, s1 - r0);
    float x[GMAX];
    if (lane < n) {
      row_dots<T, D>(q_s, kb + (size_t)(r0 + lane) * D, G, x);
      const float bv = bb == nullptr ? 0.f : bb[r0 + lane];
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        x[g] = softcap_f(x[g] * sm_scale, cap) + bv;
    } else {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) x[g] = NEG_INF_F;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {  // G is uniform: the whole warp takes the shuffles
        const float m_new = fmaxf(m[g], warp_max(x[g]));
        const float p = lane < n ? expf(x[g] - m_new) : 0.f;
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = m_new;
        p_s[warp][g][lane] = p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] *= alpha;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const T* vr = vb + (size_t)(r0 + j) * D;
      float vv[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? to_f(vr[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pj = p_s[warp][g][j];
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

  // Merge the warps' states; a warp that got no rows holds (-1e30, 0, 0)
  // and adds nothing.
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        w_m[warp][g] = m[g];
        w_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) w_acc[warp][g * D + d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
    const int g = t / D, d = t % D;
    float mx = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) mx = fmaxf(mx, w_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float sc = expf(w_m[w][g] - mx);
      lsum += w_l[w][g] * sc;
      a += w_acc[w][t] * sc;
    }
    // Row of this (b, head) and chunk: final outputs when nsplit == 1,
    // else the chunk's unnormalised partial for the merge kernel.
    const size_t prow = ((size_t)bh * G + g) * nsplit + split;
    o[prow * D + d] = nsplit == 1 ? a / fmaxf(lsum, 1e-30f) : a;
    if (d == 0) {
      m_out[prow] = mx;
      l_out[prow] = lsum;
    }
  }
}

// One block per (b, head): merge the nsplit chunk partials exactly.
__global__ void flash_decode_merge_kernel(const float* __restrict__ o_part,
                                          const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          float* __restrict__ o,
                                          float* __restrict__ m_out,
                                          float* __restrict__ l_out,
                                          int nsplit, int D) {
  const size_t row = blockIdx.x;
  const float* mp = m_part + row * nsplit;
  const float* lp = l_part + row * nsplit;
  float mx = NEG_INF_F;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, mp[s]);
  float lsum = 0.f;
  for (int s = 0; s < nsplit; ++s) lsum += lp[s] * expf(mp[s] - mx);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s)
      a += o_part[(row * nsplit + s) * D + d] * expf(mp[s] - mx);
    o[row * D + d] = a / fmaxf(lsum, 1e-30f);
  }
  if (threadIdx.x == 0) {
    m_out[row] = mx;
    l_out[row] = lsum;
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, float* o, float* m, float* l,
                  float* o_part, float* m_part, float* l_part, int B,
                  int Hkv, int G, int S, int D, int chunk, float sm_scale,
                  float cap, cudaStream_t stream) {
  if (G < 1 || G > GMAX || S < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + chunk - 1) / chunk;
  const dim3 grid(nsplit, B * Hkv);
  float* po = nsplit == 1 ? o : o_part;
  float* pm = nsplit == 1 ? m : m_part;
  float* pl = nsplit == 1 ? l : l_part;
  DISPATCH_HEAD_DIM(D, {
    flash_decode_kernel<T, kD><<<grid, FD_WARPS * 32, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, bias, po, pm, pl, G, S, chunk,
        sm_scale, cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nsplit == 1) return (int)err;
    flash_decode_merge_kernel<<<B * Hkv * G, 128, 0, stream>>>(
        o_part, m_part, l_part, o, m, l, nsplit, kD);
    return (int)cudaGetLastError();
  })
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v); bias may be NULL; cap <= 0:
// no softcap.  o_part (B*H, nsplit, D), m_part / l_part (B*H, nsplit) are
// the wrapper's scratch for nsplit = ceil(S / chunk) > 1 (may be NULL
// otherwise).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   float* o, float* m, float* l,
                                   float* o_part, float* m_part,
                                   float* l_part, int B, int Hkv, int G,
                                   int S, int D, int chunk, float sm_scale,
                                   float cap, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, o, m, l, o_part, m_part,
                                 l_part, B, Hkv, G, S, D, chunk, sm_scale,
                                 cap, st);
  return launch<float>(q, k, v, bias, o, m, l, o_part, m_part, l_part, B,
                       Hkv, G, S, D, chunk, sm_scale, cap, st);
}
