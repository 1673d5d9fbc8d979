// block_gather_attention's fp8 cache branch (per-block scales): the
// instantiations of block_gather.cuh for TK = __nv_fp8_e4m3, compiled beside
// block_gather.cu, which holds the C entry point.
#include "block_gather.cuh"

template int gather_launch<float, __nv_fp8_e4m3>(const GatherArgs&,
                                                 cudaStream_t);
template int gather_launch<__nv_bfloat16, __nv_fp8_e4m3>(const GatherArgs&,
                                                         cudaStream_t);
