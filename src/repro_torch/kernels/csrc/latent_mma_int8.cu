// The latent core's tensor-core block_gather on an int8 cache
// (latent_mma.cuh: the codes widened to bf16 exactly, one k- and v-scale
// per cluster block, bf16 extras), compiled beside latent_mma.cu.
#include "latent_mma.cuh"

template int lm::gather_launch<int8_t>(const LatentGatherArgs&, int, int,
                                      int, cudaStream_t);
