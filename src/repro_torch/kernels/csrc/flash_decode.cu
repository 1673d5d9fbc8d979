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
// a call, in a decode loop that is bound by its launches.  At G = 4 a
// tile's products are far below the size at which tensor cores would pay;
// bf16 rows of a group in the head bucket of 16 (command-r-plus's G = 12:
// 3x the work a byte) stream through the tensor-core core of
// decode_mma.cuh instead, in the same grid, chunks and merge (the wrapper
// chooses: _build.decode_mma).
//
// Masking follows the reference: a logit with the -1e30 bias enters the
// softmax like any other (an all-masked key set gives exp(0) = 1 per key,
// as the Pallas kernel does); rows past the end of S do not exist and are
// skipped.  m starts at the -1e30 sentinel, which is the reference's
// max(m, NEG_INF) clamp.  With one chunk (S at most one chunk: the self
// token, the 64 / 65 centroid tables) the block writes the normalised
// output itself and no block merges.
#include "decode_mma.cuh"

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  float* o;
  float* m_out;
  float* l_out;
  float* o_part;
  float* m_part;
  float* l_part;
  unsigned* tickets;
  int Hkv, G, S, chunk, kv_sb, kv_sh;
  float sm_scale, cap;
};

// One block a (chunk, b * Hkv + h); Core: the CUDA-core stream of
// decode_core.cuh (dc::CudaCore) or the tensor-core one of decode_mma.cuh
// (dm::Core).
template <typename T, int D, typename Core>
__global__ void __launch_bounds__(dc::WARPS * 32, Core::MIN_BLOCKS)
    flash_decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;  // b * Hkv + h
  const int G = a.G, S = a.S, Hkv = a.Hkv;
  const int s0 = split * a.chunk, n = min(S, s0 + a.chunk) - s0;
  const float sm_scale = a.sm_scale, cap = a.cap;

  Core::template stage<T>(reinterpret_cast<const T*>(a.q) +
                              (size_t)bh * G * D,
                          G, smem);
  __syncthreads();
  const float* bb = a.bias == nullptr ? nullptr : a.bias + (size_t)bh * S + s0;
  const auto logit = [=](float raw, int r) {
    return softcap_f(raw * sm_scale, cap) + (bb == nullptr ? 0.f : bb[r]);
  };
  typename Core::State st;
  // K/V may be a view: rows D apart, heads kv_sh and batches kv_sb
  // elements apart (a sliding window's last S rows of a longer cache).
  const size_t off = (size_t)(bh / Hkv) * a.kv_sb +
                     (size_t)(bh % Hkv) * a.kv_sh + (size_t)s0 * D;
  Core::template stream<T>(reinterpret_cast<const T*>(a.k) + off,
                           reinterpret_cast<const T*>(a.v) + off, n, G, logit,
                           smem, st);
  Core::merge(st, G, smem, [&](int g, int d, float m, float l, float acc) {
    // Final outputs with one chunk, else the chunk's partial.
    const size_t row = (size_t)bh * G + g;
    if (nsplit == 1) {
      a.o[row * D + d] = dc::normalise<false>(acc, l);
      if (d == 0) {
        a.m_out[row] = m;
        a.l_out[row] = l;
      }
    } else {
      const size_t prow = row * nsplit + split;
      a.o_part[prow * D + d] = acc;
      if (d == 0) {
        a.m_part[prow] = m;
        a.l_part[prow] = l;
      }
    }
  });
  if (nsplit > 1)
    dc::merge_if_last<false, D, Core::GB>(
        a.tickets + bh, nsplit, G, (size_t)bh * G, a.o_part, a.m_part,
        a.l_part, a.o, a.m_out, a.l_out, reinterpret_cast<float*>(smem),
        Core::SCRATCH);
}

template <typename T, int D, typename Core>
static int run(const DecodeArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Core::SMEM;
  cudaError_t err = allow_smem(flash_decode_kernel<T, D, Core>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<T, D, Core><<<grid, dc::WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// mma: 1 = the tensor-core stream (bf16 only), with two ring slots a team
// of warps (one measured slower over a chunk of 512 rows, PERF.md §6); 0 =
// the CUDA-core stream, which is not built for bf16 in the head bucket of
// 16 (those calls take the tensor cores).
template <typename T>
static int launch(const DecodeArgs& a, int B, int D, int mma,
                  cudaStream_t stream) {
  if (a.G < 1 || a.G > GMAX || a.S < 1 || a.chunk < 1)
    return (int)cudaErrorInvalidValue;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const dim3 grid((a.S + a.chunk - 1) / a.chunk, B * a.Hkv);
  DISPATCH_HEAD_DIM(D, {
    if constexpr (kBf16) {
      if (mma == 1) return run<T, kD, dm::Core<kD, 2>>(a, grid, stream);
    }
    if (mma != 0) return (int)cudaErrorInvalidValue;
    DISPATCH_HEAD_BUCKET(a.G, {
      if constexpr (kBf16 && kGB == 16)
        return (int)cudaErrorInvalidValue;
      else
        return run<T, kD, dc::CudaCore<T, T, kD, kGB>>(a, grid, stream);
    })
  })
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v); bias may be NULL; cap <= 0:
// no softcap.  k and v share their strides: rows D elements apart, heads
// kv_sh and batches kv_sb (a contiguous (B, Hkv, S, D): S * D and Hkv * S *
// D).  o_part (B*H, nsplit, D), m_part / l_part (B*H, nsplit) are
// the wrapper's scratch for nsplit = ceil(S / chunk) > 1, and tickets (B *
// Hkv) its zeroed counters of the last-block merge, which the kernel
// leaves zeroed (all may be NULL with one chunk).  mma: the stream, as
// launch() takes it (the wrapper's choice: _build.decode_mma).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   float* o, float* m, float* l,
                                   float* o_part, float* m_part,
                                   float* l_part, unsigned* tickets, int B,
                                   int Hkv, int G, int S, int D, int chunk,
                                   int kv_sb, int kv_sh, float sm_scale,
                                   float cap, int dtype, int mma,
                                   void* stream) {
  const DecodeArgs a{q, k, v, bias, o, m, l, o_part, m_part, l_part,
                     tickets, Hkv, G, S, chunk, kv_sb, kv_sh, sm_scale, cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, D, mma, st);
  if (dtype == 0) return launch<float>(a, B, D, mma, st);
  return (int)cudaErrorInvalidValue;
}
