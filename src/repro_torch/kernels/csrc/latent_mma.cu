// The latent core's tensor-core kernels (latent_mma.cuh) on bf16 rows:
// flash_decode_latent and block_gather_latent's bf16 cache, and the merge
// of their partials.  latent_mma_int8.cu / latent_mma_fp8.cu hold
// block_gather's int8 / fp8 cache; latent_decode.cu the C entry points.
#include "latent_mma.cuh"

namespace lm {

// One block a row: the parts' m and l staged in shared memory with their
// weights exp(m_s - m) (each loaded once, all in flight together), then
// each thread four columns, eight parts' loads in flight at once.
template <bool SIGNED>
__global__ void __launch_bounds__(256) latent_merge_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int nparts,
    int D) {
  extern __shared__ float mp[];  // the parts' m, then l, then weights
  float* lp = mp + nparts;
  float* wp = lp + nparts;
  __shared__ float mx_s, l_s;
  const size_t row = blockIdx.x;
  for (int s = threadIdx.x; s < nparts; s += blockDim.x) {
    mp[s] = __ldg(m_part + row * nparts + s);
    lp[s] = __ldg(l_part + row * nparts + s);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = NEG_INF_F;
    for (int s = 0; s < nparts; ++s) mx = fmaxf(mx, mp[s]);
    mx_s = mx;
  }
  __syncthreads();
  const float mx = mx_s;
  for (int s = threadIdx.x; s < nparts; s += blockDim.x)
    wp[s] = expf(mp[s] - mx);
  __syncthreads();
  if (threadIdx.x == 0) {
    float ls = 0.f;
    for (int s = 0; s < nparts; ++s) ls = fmaf(lp[s], wp[s], ls);
    l_s = ls;
  }
  __syncthreads();
  const float ls = l_s;
  for (int c = 4 * threadIdx.x; c < D; c += 4 * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < nparts; ++s) {
      const float w = wp[s];
      const float4 x = __ldg(
          reinterpret_cast<const float4*>(o_part + (row * nparts + s) * D + c));
      a.x = fmaf(x.x, w, a.x);
      a.y = fmaf(x.y, w, a.y);
      a.z = fmaf(x.z, w, a.z);
      a.w = fmaf(x.w, w, a.w);
    }
    *reinterpret_cast<float4*>(o + row * D + c) = make_float4(
        dc::normalise<SIGNED>(a.x, ls), dc::normalise<SIGNED>(a.y, ls),
        dc::normalise<SIGNED>(a.z, ls), dc::normalise<SIGNED>(a.w, ls));
  }
  if (threadIdx.x == 0) {
    m_out[row] = mx;
    l_out[row] = ls;
  }
}

int merge_launch(bool signed_l, const float* o_part, const float* m_part,
                 const float* l_part, float* o, float* m, float* l, int rows,
                 int nparts, int D, cudaStream_t stream) {
  const int threads = min(256, round_up(D / 4, 32));
  const size_t smem = 3 * (size_t)nparts * sizeof(float);
  cudaError_t err = allow_smem(latent_merge_kernel<true>, smem);
  if (err == cudaSuccess) err = allow_smem(latent_merge_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (signed_l)
    latent_merge_kernel<true><<<rows, threads, smem, stream>>>(
        o_part, m_part, l_part, o, m, l, nparts, D);
  else
    latent_merge_kernel<false><<<rows, threads, smem, stream>>>(
        o_part, m_part, l_part, o, m, l, nparts, D);
  return (int)cudaGetLastError();
}

int decode_launch(const DecodeArgs& a, const void* k, const void* v, int B,
                  int D, long long kv_sb, long long kv_sh,
                  cudaStream_t stream) {
  const int nsplit = (a.S + a.chunk - 1) / a.chunk;
  const dim3 grid(nsplit, (a.G + HEADS - 1) / HEADS, B * a.Hkv);
  DISPATCH_LATENT_DIM(D, {
    using C = Cfg<kD>;
    CUtensorMap km, vm;
    if (!rows_map<kD>(&km, k, B, a.Hkv, a.S, kv_sb, kv_sh) ||
        !rows_map<kD>(&vm, v, B, a.Hkv, a.S, kv_sb, kv_sh))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(latent_flash_decode_wgmma<kD>, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    latent_flash_decode_wgmma<kD><<<grid, THREADS, C::SMEM, stream>>>(km, vm,
                                                                      a);
    err = cudaGetLastError();
    if (err != cudaSuccess || nsplit == 1) return (int)err;
    return merge_launch(false, a.o_part, a.m_part, a.l_part, a.o, a.m, a.l,
                        B * a.Hkv * a.G, nsplit, kD, stream);
  })
}

template int gather_launch<__nv_bfloat16>(const LatentGatherArgs&, int, int,
                                          int, cudaStream_t);

}  // namespace lm
