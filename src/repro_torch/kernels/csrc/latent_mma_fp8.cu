// The latent core's tensor-core block_gather on an fp8 e4m3 cache
// (latent_mma.cuh: the codes widened to bf16 exactly, one k- and v-scale
// per cluster block, bf16 extras), compiled beside latent_mma.cu.
#include "latent_mma.cuh"

template int lm::gather_launch<__nv_fp8_e4m3>(const LatentGatherArgs&, int,
                                             int, int, cudaStream_t);
