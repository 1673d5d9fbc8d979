// The latent core's fp8 e4m3 branches: stage 1 (fused_synopsis_score_attention,
// one scale per centroid row) and stage 2 (block_gather_attention, one
// scale per cluster block, beside f32 extras: with bf16 extras the cache
// goes to latent_mma.cuh), the instantiations of latent_decode.cuh for TK
// = __nv_fp8_e4m3, compiled beside latent_decode.cu, which holds the C entry
// points.
#include "latent_decode.cuh"

template int latent_gather_launch<__nv_fp8_e4m3, float>(
    const LatentGatherArgs&, int, int, cudaStream_t);
template int latent_synopsis_launch<__nv_fp8_e4m3>(
    const LatentSynopsisArgs&, int, int, cudaStream_t);
