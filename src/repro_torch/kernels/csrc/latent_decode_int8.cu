// The latent core's int8 branches: stage 1 (fused_synopsis_score_attention,
// one scale per centroid row) and stage 2 (block_gather_attention, one
// scale per cluster block, beside f32 extras: with bf16 extras the cache
// goes to latent_mma.cuh), the instantiations of latent_decode.cuh for TK
// = int8_t, compiled beside latent_decode.cu, which holds the C entry
// points.
#include "latent_decode.cuh"

template int latent_gather_launch<int8_t, float>(
    const LatentGatherArgs&, int, int, cudaStream_t);
template int latent_synopsis_launch<int8_t>(
    const LatentSynopsisArgs&, int, int, cudaStream_t);
