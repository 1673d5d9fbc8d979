// Stage 2 of AccuracyTrader decode: exact attention over the selected
// clusters' original tokens, with the fused decrement and extras epilogues.
//
// Replaces: src/repro/kernels/block_gather_attention.py,
// block_gather_attention (pl.pallas_call at :255, body _kernel at :52),
// with the decrement (k_sel/v_sel/sel_bias) and extras (recent ring +
// self-KV) inputs, and its quantized branch (`has_kq`, :57, :86-90, :108):
// int8 / fp8 sorted k / v with one f32 scale per cluster block, read
// through the same clamped id that picks the block (the Pallas
// `_scale_index`, :206-209), on the cluster's raw logits and on its p
// entering p.V; the decrement and the extras take no scale.  Under a
// quantized synopsis the decrement rows arrive dequantized in f32 while q
// and the extras keep the compute type (dec_dtype).
//
// What bounds it on the H100: bytes.  Per (b, hkv) it reads I clusters of
// C rows of K and V, I centroid rows and E extras rows, with ~2 flops per
// byte at G = 4 (33.5 MB, ~10 us, at I = 32, C = 128, B = 2, Hkv = 8, bf16).
// The TPU kernel walks the I clusters in sequence on one core, steered by
// the scalar-prefetched ids; here every selected cluster is a block of its
// own and the extras one or more more, so the grid is (I + extras chunks)
// x B * Hkv (544 blocks at that shape), and each block streams its
// span through the shared decode core (decode_core.cuh: per-warp cp.async
// tiles, register state, 16-byte reads; 16 codes a copy for an int8 / fp8
// cache; five blocks an SM, so the 544 blocks are one wave; a bf16 cache
// read by a group in the head bucket of 16, command-r-plus's G = 12, takes
// the tensor-core stream of decode_mma.cuh in the same grid and
// epilogues).  The cache is cluster-contiguous, so a selected cluster is C
// consecutive rows: the block reads its id from `selected` itself (the
// scalar prefetch) and never materialises a gathered copy.  A cluster block
// folds its centroid's stage-1 term in with weight -1 (decremental
// masking): softcap(q.k_sel * scale) + sel_bias merged into the block's
// partial as a row of its own with l = -1, acc = -v_sel.  `-1` ids read
// cluster 0 with every logit (and the decrement's) at the -1e30 sentinel,
// exactly as the Pallas kernel and the reference do: an all-padded chunk's
// partial (m = -1e30, l = C - 1) is wiped out in the merge by any finite m
// elsewhere, and with no extras every such chunk survives, as in the
// unsplit sum.  Partials are stored unnormalised (a cluster's l cancels to
// ~0 when its keys are all equal, and may go negative) and the last block
// of each (b, hkv) row to finish merges them with the signed rule: o
// divided by l only where |l| > 1e-30.  With one part (I = 1 and no
// extras) the block writes the output itself.
//
// The kernel and its launch are templates in block_gather.cuh; this file
// holds the C entry point and the unquantized instantiations, and
// block_gather_int8.cu / block_gather_fp8.cu the quantized ones, so that
// the three compile side by side.
#include "block_gather.cuh"

extern template int gather_launch<float, int8_t>(const GatherArgs&,
                                                cudaStream_t);
extern template int gather_launch<__nv_bfloat16, int8_t>(const GatherArgs&,
                                                        cudaStream_t);
extern template int gather_launch<float, __nv_fp8_e4m3>(const GatherArgs&,
                                                       cudaStream_t);
extern template int gather_launch<__nv_bfloat16, __nv_fp8_e4m3>(
    const GatherArgs&, cudaStream_t);

template <typename T>
static int launch_storage(const GatherArgs& a, int dtype, int storage,
                          cudaStream_t st) {
  if (storage == dtype) return gather_launch<T, T>(a, st);
  if (storage == 2) return gather_launch<T, int8_t>(a, st);
  if (storage == 3) return gather_launch<T, __nv_fp8_e4m3>(a, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, extras); storage: k / v's type (0,
// 1, or 2 = int8, 3 = fp8 with kv_k_scale / kv_v_scale (B, Hkv, M) f32;
// NULL scales with an unquantized cache); dec_dtype: k_sel / v_sel's type
// (dtype's, or 0 = float32).  k_sel == NULL: no decrement; ek == NULL: no
// extras, else ceil(E / xrows) chunks of xrows rows.  rows: (B) the cache
// row of each batch row in k / v's leading axis (the fleet tier's row map),
// or NULL (the identity); the scales, the selection and the decrement stay
// indexed by the batch row.  o (B*H, D), m, l (B*H) are the outputs;
// o_part (B*H, nparts, D), m_part / l_part (B*H, nparts) the wrapper's
// scratch for nparts = I + extras chunks > 1, and tickets (B * Hkv) its
// zeroed counters of the last-block merge, which the kernel leaves zeroed
// (all may be NULL with one part).  cap <= 0: no softcap.  mma: 1 = the
// tensor-core stream (decode_mma.cuh), for bf16 q, cache and extras only;
// 0 = the CUDA-core stream (the wrapper's choice: _build.decode_mma).
extern "C" int block_gather_launch(
    const void* q, const void* k, const void* v, const int* selected,
    const void* k_sel, const void* v_sel, const float* sel_bias,
    const void* ek, const void* ev, const float* eb, const float* kv_k_scale,
    const float* kv_v_scale, const int* rows, float* o, float* m, float* l,
    float* o_part, float* m_part, float* l_part, unsigned* tickets, int B,
    int Hkv, int G, int S, int D, int C, int I, int E, int xrows,
    float sm_scale, float cap, int dtype, int storage, int dec_dtype, int mma,
    void* stream) {
  if (k_sel != nullptr && dec_dtype != dtype && dec_dtype != 0)
    return (int)cudaErrorInvalidValue;
  const GatherArgs a{q, k, v, selected, k_sel, v_sel, sel_bias, ek, ev, eb,
                     kv_k_scale, kv_v_scale, rows, o, m, l, o_part, m_part,
                     l_part, tickets, B, Hkv, G, S, D, C, I, E, xrows,
                     sm_scale, cap, dec_dtype == 0, mma};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_storage<__nv_bfloat16>(a, dtype, storage, st);
  if (dtype == 0) return launch_storage<float>(a, dtype, storage, st);
  return (int)cudaErrorInvalidValue;
}
