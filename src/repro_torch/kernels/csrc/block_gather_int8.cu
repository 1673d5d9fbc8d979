// block_gather_attention's int8 cache branch (per-block scales): the
// instantiations of block_gather.cuh for TK = int8_t, compiled beside
// block_gather.cu, which holds the C entry point.
#include "block_gather.cuh"

template int gather_launch<float, int8_t>(const GatherArgs&,
                                          cudaStream_t);
template int gather_launch<__nv_bfloat16, int8_t>(const GatherArgs&,
                                                  cudaStream_t);
