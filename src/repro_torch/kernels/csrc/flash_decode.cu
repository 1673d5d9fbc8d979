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
// design is split-S on the shared decode core (decode_core.cuh): the grid
// is (S / chunk, B * Hkv), the wrapper picks the chunk for about two
// blocks an SM (chunks of 512 rows at that shape, whole rounds of one tile
// for each of the block's warps), each block streams its chunk through
// per-warp cp.async tiles, with the tiles of other warps in flight while
// one warp computes, and the last block of each (b, hkv) row to
// finish merges the chunks' unnormalised partials (the TPU kernel's
// sequential S axis carried the state in VMEM scratch instead): one launch
// a call, in a decode loop that is bound by its launches.  No tensor
// cores: at G = 4 a tile's products are far below the size at which they
// would pay.
//
// Masking follows the reference: a logit with the -1e30 bias enters the
// softmax like any other (an all-masked key set gives exp(0) = 1 per key,
// as the Pallas kernel does); rows past the end of S do not exist and are
// skipped.  m starts at the -1e30 sentinel, which is the reference's
// max(m, NEG_INF) clamp.  With one chunk (S at most one chunk: the self
// token, the 64 / 65 centroid tables) the block writes the normalised
// output itself and no block merges.
#include "decode_core.cuh"

template <typename T, int D, int GB>
__global__ void __launch_bounds__(dc::WARPS * 32) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part,
    unsigned* __restrict__ tickets, int Hkv, int G, int S, int chunk,
    int kv_sb, int kv_sh, float sm_scale, float cap) {
  using Sm = dc::Smem<T, T, D, GB>;
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;  // b * Hkv + h
  const int s0 = split * chunk, n = min(S, s0 + chunk) - s0;

  dc::stage_q<T, T, D, GB>(q + (size_t)bh * G * D, G, Sm::q_s(smem));
  __syncthreads();
  const float* bb = bias == nullptr ? nullptr : bias + (size_t)bh * S + s0;
  const auto logit = [=](float raw, int r) {
    return softcap_f(raw * sm_scale, cap) + (bb == nullptr ? 0.f : bb[r]);
  };
  dc::WarpState<GB> st;
  // K/V may be a view: rows D apart, heads kv_sh and batches kv_sb
  // elements apart (a sliding window's last S rows of a longer cache).
  const size_t off = (size_t)(bh / Hkv) * kv_sb + (size_t)(bh % Hkv) * kv_sh +
                     (size_t)s0 * D;
  dc::stream_chunk<T, D, GB>(k + off, v + off, n, G, Sm::q_s(smem), logit,
                             Sm::ring(smem), Sm::p_s(smem), st);
  dc::block_merge<D, GB>(st, G, smem, [&](int g, int d, float m, float l,
                                          float a) {
    // Final outputs with one chunk, else the chunk's partial.
    const size_t row = (size_t)bh * G + g;
    if (nsplit == 1) {
      o[row * D + d] = dc::normalise<false>(a, l);
      if (d == 0) {
        m_out[row] = m;
        l_out[row] = l;
      }
    } else {
      const size_t prow = row * nsplit + split;
      o_part[prow * D + d] = a;
      if (d == 0) {
        m_part[prow] = m;
        l_part[prow] = l;
      }
    }
  });
  if (nsplit > 1)
    dc::merge_if_last<false, D, GB>(
        tickets + bh, nsplit, G, (size_t)bh * G, o_part, m_part, l_part, o,
        m_out, l_out, reinterpret_cast<float*>(smem), Sm::P_OFF / 4);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, float* o, float* m, float* l,
                  float* o_part, float* m_part, float* l_part,
                  unsigned* tickets, int B, int Hkv, int G, int S, int D,
                  int chunk, int kv_sb, int kv_sh, float sm_scale, float cap,
                  cudaStream_t stream) {
  if (G < 1 || G > GMAX || S < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + chunk - 1) / chunk;
  const dim3 grid(nsplit, B * Hkv);
  DISPATCH_HEAD_DIM(D, DISPATCH_HEAD_BUCKET(G, {
    constexpr int smem = dc::Smem<T, T, kD, kGB>::BYTES;
    cudaError_t err = allow_smem(flash_decode_kernel<T, kD, kGB>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_decode_kernel<T, kD, kGB><<<grid, dc::WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, bias, o, m, l, o_part, m_part,
        l_part, tickets, Hkv, G, S, chunk, kv_sb, kv_sh, sm_scale, cap);
    return (int)cudaGetLastError();
  }))
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v); bias may be NULL; cap <= 0:
// no softcap.  k and v share their strides: rows D elements apart, heads
// kv_sh and batches kv_sb (a contiguous (B, Hkv, S, D): S * D and Hkv * S *
// D).  o_part (B*H, nsplit, D), m_part / l_part (B*H, nsplit) are
// the wrapper's scratch for nsplit = ceil(S / chunk) > 1, and tickets (B *
// Hkv) its zeroed counters of the last-block merge, which the kernel
// leaves zeroed (all may be NULL with one chunk).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   float* o, float* m, float* l,
                                   float* o_part, float* m_part,
                                   float* l_part, unsigned* tickets, int B,
                                   int Hkv, int G, int S, int D, int chunk,
                                   int kv_sb, int kv_sh, float sm_scale,
                                   float cap, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, o, m, l, o_part, m_part,
                                 l_part, tickets, B, Hkv, G, S, D, chunk,
                                 kv_sb, kv_sh, sm_scale, cap, st);
  return launch<float>(q, k, v, bias, o, m, l, o_part, m_part, l_part,
                       tickets, B, Hkv, G, S, D, chunk, kv_sb, kv_sh,
                       sm_scale, cap, st);
}
