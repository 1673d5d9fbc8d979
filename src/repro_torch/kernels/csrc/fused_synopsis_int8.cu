// fused_synopsis_score_attention's int8 table branch (per-row scales): the
// instantiations of fused_synopsis.cuh for TK = int8_t, compiled beside
// fused_synopsis.cu, which holds the C entry point.
#include "fused_synopsis.cuh"

template int synopsis_launch<float, int8_t>(const SynopsisArgs&, int, int,
                                            cudaStream_t);
template int synopsis_launch<__nv_bfloat16, int8_t>(const SynopsisArgs&, int,
                                                    int, cudaStream_t);
