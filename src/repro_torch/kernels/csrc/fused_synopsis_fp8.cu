// fused_synopsis_score_attention's fp8 table branch (per-row scales): the
// instantiations of fused_synopsis.cuh for TK = __nv_fp8_e4m3, compiled
// beside fused_synopsis.cu, which holds the C entry point.
#include "fused_synopsis.cuh"

template int synopsis_launch<float, __nv_fp8_e4m3>(const SynopsisArgs&, int,
                                                   int, cudaStream_t);
template int synopsis_launch<__nv_bfloat16, __nv_fp8_e4m3>(
    const SynopsisArgs&, int, int, cudaStream_t);
