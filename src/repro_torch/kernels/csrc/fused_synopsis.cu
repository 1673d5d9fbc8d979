// Stage 1 of AccuracyTrader decode: fused centroid scoring + count-biased
// synopsis attention, in one pass over k_syn / v_syn.
//
// Replaces: src/repro/kernels/fused_synopsis.py, fused_synopsis_score_attention
// (pl.pallas_call at :139, body _kernel at :41), with its quantized branch
// (`has_scale`, :45, :63-66, :85): int8 / fp8 tables with one f32 scale per
// centroid row, the k-scale on the raw logits before sm_scale, the v-scale
// on p entering p.V (l unscaled).  The codes widen to f32 as the tile is
// read from shared memory; no dequantized table lands in device memory.
//
// What bounds it on the H100: bytes.  Per (b, hkv) the kernel reads M
// centroid rows of K and V once and does 4 * G * M * D flops; at G = 4
// that is ~2 flops per byte in bf16, far below the ~295 the tensor cores
// need, so the floor is the HBM read of the tables.  Each centroid row's
// G logits are computed once and used twice: the group-max scores for
// top-k (scaled, uncapped, over the G real heads) and the softcapped,
// log(count)-biased online softmax.
//
// The design is the split-and-merge decode core of flash_decode.cu
// (decode_core.cuh): the grid is (M / chunk, B * Hkv), the wrapper sizes
// the chunk as flash_decode's does (one chunk at the loop's M = 64 / 65,
// where each warp takes one tile and no block merges; ~8 chunks at M =
// 1024), each block streams its chunk's rows through per-warp cp.async
// tiles, and the last block of each (b, hkv) row to finish merges the
// chunks' unnormalised partials exactly (the TPU kernel's sequential M
// axis carried the state in VMEM scratch instead).  What stage 1 adds to
// the core, as hooks that cost flash_decode and block_gather nothing:
//  * the scores: the core hands each row's raw dots of all heads to one
//    lane, which writes the row's group-max score; every row belongs to
//    one chunk, so the scores need no merge;
//  * the count bias and the k-scale: in the logit, per row;
//  * the v-scale: per row, on p after it was added to l.
// l >= 0 here (no decrement), so the output is acc / max(l, 1e-30).
//
// The kernel and its launch are templates in fused_synopsis.cuh; this
// file holds the C entry point and the unquantized instantiations, and
// fused_synopsis_int8.cu / fused_synopsis_fp8.cu the quantized ones, so
// that the three compile side by side.
#include "fused_synopsis.cuh"

extern template int synopsis_launch<float, int8_t>(const SynopsisArgs&, int,
                                                   int, cudaStream_t);
extern template int synopsis_launch<__nv_bfloat16, int8_t>(
    const SynopsisArgs&, int, int, cudaStream_t);
extern template int synopsis_launch<float, __nv_fp8_e4m3>(
    const SynopsisArgs&, int, int, cudaStream_t);
extern template int synopsis_launch<__nv_bfloat16, __nv_fp8_e4m3>(
    const SynopsisArgs&, int, int, cudaStream_t);

template <typename T>
static int launch_storage(const SynopsisArgs& a, int B, int D, int dtype,
                          int storage, cudaStream_t st) {
  if (storage == dtype) return synopsis_launch<T, T>(a, B, D, st);
  if (storage == 2) return synopsis_launch<T, int8_t>(a, B, D, st);
  if (storage == 3) return synopsis_launch<T, __nv_fp8_e4m3>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q); storage: the tables' type (0, 1,
// or 2 = int8, 3 = fp8 with k_scale / v_scale (B, Hkv, M) f32; NULL scales
// with unquantized tables); cap <= 0: no softcap.  o (B*H, D), m, l (B*H)
// are the outputs; o_part (B*H, nsplit, D), m_part / l_part (B*H, nsplit)
// the wrapper's scratch for nsplit = ceil(M / chunk) > 1, and tickets (B *
// Hkv) its zeroed counters of the last-block merge, which the kernel
// leaves zeroed (all may be NULL with one chunk).
extern "C" int fused_synopsis_launch(
    const void* q, const void* k_syn, const void* v_syn, const float* cbias,
    const float* k_scale, const float* v_scale, float* scores, float* o,
    float* m, float* l, float* o_part, float* m_part, float* l_part,
    unsigned* tickets, int B, int Hkv, int G, int M, int D, int chunk,
    float sm_scale, float cap, int dtype, int storage, void* stream) {
  if ((storage >= 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const SynopsisArgs a{q, k_syn, v_syn, cbias, k_scale, v_scale, scores,
                       o, m, l, o_part, m_part, l_part, tickets,
                       Hkv, G, M, chunk, sm_scale, cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_storage<__nv_bfloat16>(a, B, D, dtype, storage, st);
  if (dtype == 0) return launch_storage<float>(a, B, D, dtype, storage, st);
  return (int)cudaErrorInvalidValue;
}
