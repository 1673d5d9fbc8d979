// Per-cluster correlation scores of the unfused synopsis op: the max over
// the GQA group's G query heads of the centroid logit, (B, Hkv, M) f32.
//
// Replaces: src/repro/kernels/synopsis_score.py, synopsis_score
// (pl.pallas_call at :46, body _kernel at :20).  Like the Pallas kernel it
// scales each logit by sm_scale before the max (the reference scales the
// max; for sm_scale > 0 the two are the same number).
//
// What bounds it on the H100: bytes, and at the loop's M = 64 / 65 the
// launch.  It reads each centroid row once (~0.26 MB at B = 2, Hkv = 8,
// M = 64, D = 128 in bf16, a ~0.08 us floor; 4.19 MB, ~1.3 us, at M =
// 1024) and does 2 * G flops per element (4 a byte at G = 4 in bf16): the
// work is keeping enough loads in flight, with no shared memory and no
// barrier.
//
//  * Grid: (chunks of M, B * Hkv); a block is 1, 2 or 4 warps, the most
//    that still gives one block per SM (8 rows a block at the loop's
//    shape: 128 blocks; 4 warps at M = 1024: 512 blocks).  Each warp takes
//    a tile of RW consecutive rows of one (b, hkv), and every block writes
//    only its own rows' scores: no merge.
//  * Loads: the tile is one flat byte range, read as LOADS 16-byte loads
//    a lane, all issued before the first FMA; load i of lane l is bytes
//    (i * 32 + l) * 16 of the tile, so each load instruction of the warp
//    reads 512 contiguous bytes.  A lane's column piece of a row is then
//    fixed (two pieces for f32 at D = 256), so its G query pieces live in
//    registers, widened to f32 (heads G .. GB - 1 zero).
//  * Dots: the LPR lanes of a row add their partial dots of every head
//    with a shuffle tree over the lane bits of the row (offsets LPR / 2
//    down to 1, a butterfly: every lane of the row ends with the sums),
//    and the row's first lane writes the max over the G real heads.  A
//    reduce-scatter (each lane keeping half its heads at each offset: GB -
//    1 shuffles a row instead of GB * log2(LPR)) measured slower at the
//    loop's M = 64 and no faster at M = 1024 in bf16 (PERF.md).
//  * Heads: G is rounded up to a bucket GB of 4, 8 or 16 (a template
//    argument), so the FMA and shuffle loops carry no head test; heads
//    past G carry a zero query and stay out of the max.  The centroid
//    rows are read once for all G heads in every bucket.
#include "decode_core.cuh"

namespace ss {

constexpr int VEC = 16;       // bytes of one load
constexpr int LOADS = 4;      // 16-byte loads a lane keeps in flight
constexpr int MAX_WARPS = 4;  // warps a block at most

// Geometry of a warp's tile of rows of D elements of T.
template <typename T, int D>
struct Geo {
  static constexpr int V = VEC / (int)sizeof(T);     // elements a load
  static constexpr int ROW = D * (int)sizeof(T);     // bytes a row
  static constexpr int WARP = 32 * VEC;              // bytes a warp load
  // Lanes a row, loads a row a lane, rows a warp load, row slots a lane.
  static constexpr int LPR = ROW < WARP ? ROW / VEC : 32;
  static constexpr int VPL = ROW > WARP ? ROW / WARP : 1;
  static constexpr int RPW = ROW < WARP ? WARP / ROW : 1;
  static constexpr int NS = LOADS / VPL;
  static constexpr int RW = NS * RPW;                // rows a warp tile
  static_assert(ROW % VEC == 0 && LOADS % VPL == 0, "D must be 16 .. 256");
};

// 16 loaded bytes widened to f32.
__device__ __forceinline__ void widen(const uint4& t, float (&o)[4]) {
  o[0] = __uint_as_float(t.x);
  o[1] = __uint_as_float(t.y);
  o[2] = __uint_as_float(t.z);
  o[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void widen(const uint4& t, float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(MAX_WARPS * 32) synopsis_score_warp_kernel(
    const T* __restrict__ q, const T* __restrict__ k_syn,
    float* __restrict__ scores, int G, int M, float sm_scale) {
  using S = Geo<T, D>;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;  // b * Hkv + h
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r0 = warp * S::RW;  // the warp tile's first row
  if (r0 >= M) return;
  const int sub = lane / S::LPR;      // row of a warp load
  const int piece = lane % S::LPR;    // column piece of that row
  const char* tile = reinterpret_cast<const char*>(k_syn) +
                     ((size_t)bh * M + r0) * S::ROW;

  uint4 kr[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int row = r0 + (i / S::VPL) * S::RPW + sub;
    kr[i] = row < M ? __ldcs(reinterpret_cast<const uint4*>(
                          tile + (i * 32 + lane) * VEC))
                    : make_uint4(0u, 0u, 0u, 0u);
  }
  float qf[S::VPL][GB][S::V];
  const T* qb = q + (size_t)bh * G * D;
#pragma unroll
  for (int p = 0; p < S::VPL; ++p)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const uint4 t = g < G ? __ldg(reinterpret_cast<const uint4*>(
                                  qb + g * D + (p * S::LPR + piece) * S::V))
                            : make_uint4(0u, 0u, 0u, 0u);
      widen(t, qf[p][g]);
    }

  float x[S::NS][GB];
#pragma unroll
  for (int s = 0; s < S::NS; ++s)
#pragma unroll
    for (int g = 0; g < GB; ++g) x[s][g] = 0.f;
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    float kv[S::V];
    widen(kr[i], kv);
    const int s = i / S::VPL, p = i % S::VPL;
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < S::V; ++e)
        x[s][g] = fmaf(qf[p][g][e], kv[e], x[s][g]);
  }

#pragma unroll
  for (int s = 0; s < S::NS; ++s) {
#pragma unroll
    for (int o = S::LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        x[s][g] += __shfl_xor_sync(0xffffffffu, x[s][g], o);
    float best = x[s][0] * sm_scale;
#pragma unroll
    for (int g = 1; g < GB; ++g)
      if (g < G) best = fmaxf(best, x[s][g] * sm_scale);
    const int row = r0 + s * S::RPW + sub;
    if (piece == 0 && row < M) scores[(size_t)bh * M + row] = best;
  }
}

// Warps a block: the most of 4, 2, 1 that still gives every SM a block.
inline int block_warps(int tiles, int rows) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int w = MAX_WARPS;
  while (w > 1 && (long long)rows * ((tiles + w - 1) / w) < sms) w /= 2;
  return w;
}

template <typename T>
int launch(const void* q, const void* k_syn, float* scores, int B, int Hkv,
           int G, int M, int D, float sm_scale, cudaStream_t stream) {
  if (G < 1 || G > GMAX || M < 1) return (int)cudaErrorInvalidValue;
  DISPATCH_HEAD_DIM(D, DISPATCH_HEAD_BUCKET(G, {
    const int tiles = (M + Geo<T, kD>::RW - 1) / Geo<T, kD>::RW;
    const int w = block_warps(tiles, B * Hkv);
    const dim3 grid((tiles + w - 1) / w, B * Hkv);
    synopsis_score_warp_kernel<T, kD, kGB><<<grid, w * 32, 0, stream>>>(
        (const T*)q, (const T*)k_syn, scores, G, M, sm_scale);
    return (int)cudaGetLastError();
  }))
}

}  // namespace ss

// dtype: 0 = float32, 1 = bfloat16 (q, k_syn).
extern "C" int synopsis_score_launch(const void* q, const void* k_syn,
                                     float* scores, int B, int Hkv, int G,
                                     int M, int D, float sm_scale, int dtype,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return ss::launch<__nv_bfloat16>(q, k_syn, scores, B, Hkv, G, M, D,
                                     sm_scale, st);
  return ss::launch<float>(q, k_syn, scores, B, Hkv, G, M, D, sm_scale, st);
}
