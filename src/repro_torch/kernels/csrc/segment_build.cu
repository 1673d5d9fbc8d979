// Synopsis build: permute the exact cache into cluster-contiguous order
// and aggregate each C-row cluster into its mean centroid, in one pass;
// optionally quantize the centroids and the sorted cache on the way out.
//
// Replaces: src/repro/kernels/synopsis_build.py, segment_build
// (pl.pallas_call at :173, body _kernel at :41), with its quantized flush
// (`quant` / `quant_kv`, :47-55, :65-67, :74-95).  The same kernel runs the
// absorb of the recent ring with the identity permutation.
//
// What bounds it on the H100: bytes.  It reads every cache row once and
// writes it once (sorted K and V, or their 1-byte codes under "+kv"), plus
// M centroid rows: no arithmetic to speak of.  One block per (n, hkv, m)
// cluster, as the Pallas kernel's VMEM block (:53-54, :65-67) is one
// cluster:
//  * the cluster's C perm indices go to shared memory once;
//  * its C x D rows of K and V are staged in shared memory with 16-byte
//    cp.async copies, all of a piece in flight at once, in GROUPS commit
//    groups so that the sums of a group's rows overlap the later groups'
//    copies (32 KB a tensor at C = D = 128 in bf16: the whole cluster,
//    three blocks an SM; a piece holds at most PIECE_BYTES of K and V, so
//    f32 rows at D = 128 come in two halves);
//  * the f32 column sums walk the staged rows in row order c = 0 .. C - 1
//    (a piece continues the sums the previous one left in shared memory),
//    so every centroid mean is the same f32 value the row-at-a-time
//    kernel summed; at the end it writes sum * (1/C), as the Pallas flush
//    does;
//  * the sorted rows go out straight from the staged piece, and under
//    "+kv" the codes (16 a thread, converted two (fp8) or one (int8) an
//    instruction and packed with byte permutes), with 16-byte stores: the
//    sorted block of a cluster is one contiguous span of the output.
//
// Quantized (TS / TKV int8 or fp8-e4m3): the centroid row is quantized
// from its f32 mean with one scale per (n, h, m) row, which needs a
// block-wide amax over D after the mean.  Under "+kv" the whole C x D
// sorted block shares one scale, so its amax must be known before any code
// is written: the sums pass takes it, and the codes are then encoded from
// the piece still staged (when the cluster is one piece, as in bf16 at
// D = 128; earlier pieces are staged again, from L2).  No f32 sorted copy
// lands in device memory, as in the Pallas kernel.  The sorted codes
// depend on no sum, so they match the plain version bit for bit; a
// centroid code follows an f32 mean whose sum order differs from torch's,
// and may sit one step away where the two means differ in their last bit.
#include "decode_core.cuh"

struct BuildArgs {
  const void* k;
  const void* v;
  const int* perm;
  void* k_sorted;
  void* v_sorted;
  void* k_syn;
  void* v_syn;
  float* counts;
  float* k_syn_scale;  // (N, Hkv, M) when the centroids are quantized
  float* v_syn_scale;
  float* k_scale;      // (N, Hkv, M) when the sorted cache is quantized
  float* v_scale;
  int N, Hkv, S, D, C;
  int CP;  // rows of a staged piece
};

constexpr int BUILD_THREADS = 128;
constexpr int BUILD_WARPS = BUILD_THREADS / 32;
// K and V bytes of one staged piece, at most: three blocks an SM.
constexpr int PIECE_BYTES = 64 * 1024;
// Commit groups a piece is copied in (at most 4: cp_async_wait_from).
constexpr int GROUPS = 4;

// Block-wide max of 4 values per thread (all threads get the result).
__device__ inline void block_max4(float (&x)[4], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < 4; ++i) {
    x[i] = warp_max(x[i]);
    if (lane == 0) scratch[i * BUILD_WARPS + warp] = x[i];
  }
  __syncthreads();
  for (int i = 0; i < 4; ++i) {
    float m = 0.f;
    for (int w = 0; w < BUILD_WARPS; ++w)
      m = fmaxf(m, scratch[i * BUILD_WARPS + w]);
    x[i] = m;
  }
}

// Two consecutive elements of shared memory, widened to f32.
__device__ __forceinline__ float2 smem2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 smem2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 consecutive elements of shared memory (16-byte aligned), widened to
// f32.
__device__ __forceinline__ void smem16(const float* p, float (&y)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    y[4 * i] = f.x;
    y[4 * i + 1] = f.y;
    y[4 * i + 2] = f.z;
    y[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void smem16(const __nv_bfloat16* p,
                                       float (&y)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = smem2(p + 2 * i);
    y[2 * i] = f.x;
    y[2 * i + 1] = f.y;
  }
}

// The codes of y[0 .. 15] (already times 1 / scale), element e in byte e:
// Quant<Q>::encode element by element, with the conversions of two (fp8)
// or one (int8) element an instruction and byte permutes to pack them.
template <typename Q>
__device__ __forceinline__ uint4 encode16(const float (&y)[16]);
template <>
__device__ __forceinline__ uint4 encode16<int8_t>(const float (&y)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Quant<int8_t>::encode(y[4 * i + j]);
    w[i] = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                       __byte_perm(b[2], b[3], 0x0040), 0x5410);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ uint4 encode16<__nv_fp8_e4m3>(
    const float (&y)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // the clip of Quant's encode, then RN
      const float2 f = make_float2(
          fminf(fmaxf(y[4 * i + 2 * j], -448.f), 448.f),
          fminf(fmaxf(y[4 * i + 2 * j + 1], -448.f), 448.f));
      h[j] = __nv_cvt_float2_to_fp8x2(f, __NV_SATFINITE, __NV_E4M3);
    }
    w[i] = __byte_perm(h[0], h[1], 0x5410);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// cp.async.wait_group n for a run-time n < GROUPS.
__device__ __forceinline__ void cp_async_wait_from(int n) {
  switch (n) {
    case 0: dc::cp_async_wait<0>(); break;
    case 1: dc::cp_async_wait<1>(); break;
    case 2: dc::cp_async_wait<2>(); break;
    default: dc::cp_async_wait<3>(); break;
  }
}

// Shared memory of a block: the staged piece (K then V, CP x D each), the
// column sums (K then V, D each), the amax scratch, the perm indices.
template <typename T>
struct BuildSmem {
  __host__ __device__ static size_t tile(int CP, int D) {
    return 2 * (size_t)CP * D * sizeof(T);
  }
  __host__ __device__ static size_t sums(int CP, int D) {
    return tile(CP, D);
  }
  __host__ __device__ static size_t red(int CP, int D) {
    return sums(CP, D) + 2 * (size_t)D * sizeof(float);
  }
  __host__ __device__ static size_t perm(int CP, int D) {
    return red(CP, D) + 4 * BUILD_WARPS * sizeof(float);
  }
  __host__ __device__ static size_t bytes(int CP, int D, int C) {
    return perm(CP, D) + (size_t)C * sizeof(int);
  }
};

// T: the cache's type; TS: the centroids' (T, or a quantized type); TKV:
// the sorted cache's (T, or TS under "+kv").
template <typename T, typename TS, typename TKV>
__global__ void __launch_bounds__(BUILD_THREADS)
    segment_build_kernel(BuildArgs a, int M) {
  constexpr bool QS = Quant<TS>::enabled, QKV = Quant<TKV>::enabled;
  constexpr int VEC = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  using L = BuildSmem<T>;
  extern __shared__ __align__(16) char smem[];
  const int D = a.D, C = a.C, CP = a.CP, tid = threadIdx.x;
  T* tile = reinterpret_cast<T*>(smem);  // [2][CP][D]
  float* sums = reinterpret_cast<float*>(smem + L::sums(CP, D));  // [2][D]
  float* red = reinterpret_cast<float*>(smem + L::red(CP, D));
  int* perm_s = reinterpret_cast<int*>(smem + L::perm(CP, D));
  const int m = blockIdx.x % M;
  const int nh = blockIdx.x / M;  // n * Hkv + h
  const int n = nh / a.Hkv, h = nh % a.Hkv;
  const size_t base = (size_t)nh * a.S * D;
  const size_t blk = base + (size_t)m * C * D;  // the sorted block's start
  const T* ksrc = (const T*)a.k + base;
  const T* vsrc = (const T*)a.v + base;
  const float inv = 1.0f / (float)C;
  const size_t o = ((size_t)nh * M + m) * D;

  const int* pn = a.perm + (size_t)n * a.S + (size_t)m * C;
  for (int c = tid; c < C; c += BUILD_THREADS) perm_s[c] = pn[c];
  for (int i = tid; i < 2 * D; i += BUILD_THREADS) sums[i] = 0.f;
  __syncthreads();

  // Copies of rows [c0, c1) of the piece that starts at cluster row p0,
  // as one commit group.
  const int RV = D / VEC;  // 16-byte copies a row
  const auto issue = [&](int p0, int c0, int c1) {
    const int U0 = c0 * RV, U = (c1 - c0) * RV;
    for (int j = tid; j < 2 * U; j += BUILD_THREADS) {
      const int t = j >= U, u = U0 + j - t * U;
      const int c = u / RV, e = (u - c * RV) * VEC;
      dc::cp_async16(tile + ((size_t)t * CP + c) * D + e,
                     (t ? vsrc : ksrc) + (size_t)perm_s[p0 + c] * D + e,
                     16);
    }
    dc::cp_async_commit();
  };

  // amax of |k mean|, |v mean|, |k block|, |v block|
  float amax[4] = {0.f, 0.f, 0.f, 0.f};
  const int half = D / 2;  // column pairs a tensor
  for (int p0 = 0; p0 < C; p0 += CP) {
    const int np = min(CP, C - p0);
    // The whole piece in flight at once, in GROUPS commit groups: the
    // block works on a group's rows while the later groups land.
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi)
      issue(p0, gi * np / GROUPS, (gi + 1) * np / GROUPS);
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      cp_async_wait_from(GROUPS - 1 - gi);
      __syncthreads();
      const int c0 = gi * np / GROUPS, c1 = (gi + 1) * np / GROUPS;
      if constexpr (!QKV) {  // sorted rows straight from the piece
        const int U0 = c0 * RV, U = (c1 - c0) * RV;
        for (int j = tid; j < 2 * U; j += BUILD_THREADS) {
          const int t = j >= U, u = U0 + j - t * U;
          T* dst = (T*)(t ? a.v_sorted : a.k_sorted) + blk + (size_t)p0 * D;
          reinterpret_cast<uint4*>(dst)[u] =
              reinterpret_cast<const uint4*>(tile + (size_t)t * CP * D)[u];
        }
      }
      // Column sums in row order: two columns a thread.
      for (int w = tid; w < D; w += BUILD_THREADS) {
        const int t = w >= half, d0 = 2 * (w - t * half);
        const T* col = tile + (size_t)t * CP * D + d0;
        float s0 = sums[t * D + d0], s1 = sums[t * D + d0 + 1], am = 0.f;
        for (int c = c0; c < c1; ++c) {
          const float2 x = smem2(col + (size_t)c * D);
          s0 += x.x;
          s1 += x.y;
          if constexpr (QKV) am = fmaxf(am, fmaxf(fabsf(x.x), fabsf(x.y)));
        }
        sums[t * D + d0] = s0;
        sums[t * D + d0 + 1] = s1;
        if constexpr (QKV) {
          if (t) amax[3] = fmaxf(amax[3], am);
          else amax[2] = fmaxf(amax[2], am);
        }
      }
    }
    __syncthreads();  // sums visible; the piece may be replaced
  }
  if (h == 0 && tid == 0) a.counts[(size_t)n * M + m] = (float)C;

  if constexpr (!QS) {
    for (int i = tid; i < 2 * D; i += BUILD_THREADS)
      ((TS*)(i < D ? a.k_syn : a.v_syn))[o + i % D] =
          from_f<TS>(sums[i] * inv);
  } else {
    for (int i = tid; i < 2 * D; i += BUILD_THREADS) {
      const float mu = sums[i] * inv;
      sums[i] = mu;
      if (i < D) amax[0] = fmaxf(amax[0], fabsf(mu));
      else amax[1] = fmaxf(amax[1], fabsf(mu));
    }
    block_max4(amax, red);  // syncs, so the means are visible
    const size_t so = (size_t)nh * M + m;
    const float qs = Quant<TS>::qmax, qkv = Quant<TKV>::qmax;
    float sc[4], iv[4];
    for (int i = 0; i < 4; ++i) {
      sc[i] = amax[i] / (i < 2 ? qs : qkv);
      iv[i] = inv_scale(sc[i]);
    }
    if (tid == 0) {
      a.k_syn_scale[so] = sc[0];
      a.v_syn_scale[so] = sc[1];
      if constexpr (QKV) {
        a.k_scale[so] = sc[2];
        a.v_scale[so] = sc[3];
      }
    }
    for (int i = tid; i < 2 * D; i += BUILD_THREADS)
      ((TS*)(i < D ? a.k_syn : a.v_syn))[o + i % D] =
          Quant<TS>::encode(sums[i] * iv[i < D ? 0 : 1]);
    if constexpr (QKV) {
      // Codes of 16 consecutive elements a thread, one 16-byte store; the
      // last piece is still staged, earlier ones are staged again.
      const int last = (C - 1) / CP;
      for (int pi = last; pi >= 0; --pi) {
        const int p0 = pi * CP, np = min(CP, C - p0);
        if (pi != last) {
          __syncthreads();
          issue(p0, 0, np);
          dc::cp_async_wait<0>();
          __syncthreads();
        }
        const int U = np * D / 16;
        for (int j = tid; j < 2 * U; j += BUILD_THREADS) {
          const int t = j >= U, u = j - t * U;
          float y[16];
          smem16(tile + (size_t)t * CP * D + (size_t)u * 16, y);
          const float ivt = t ? iv[3] : iv[2];
#pragma unroll
          for (int e = 0; e < 16; ++e) y[e] *= ivt;
          TKV* dst = (TKV*)(t ? a.v_sorted : a.k_sorted) + blk +
                     (size_t)p0 * D;
          reinterpret_cast<uint4*>(dst)[u] = encode16<TKV>(y);
        }
      }
    }
  }
}

template <typename T, typename TS, typename TKV>
static int launch(BuildArgs a, cudaStream_t stream) {
  if (a.C < 1 || a.S % a.C || a.D % 16) return (int)cudaErrorInvalidValue;
  const int M = a.S / a.C;
  a.CP = max(1, min(a.C, PIECE_BYTES / (2 * a.D * (int)sizeof(T))));
  const size_t smem = BuildSmem<T>::bytes(a.CP, a.D, a.C);
  cudaError_t err = allow_smem(segment_build_kernel<T, TS, TKV>, smem);
  if (err != cudaSuccess) return (int)err;
  segment_build_kernel<T, TS, TKV>
      <<<a.N * a.Hkv * M, BUILD_THREADS, smem, stream>>>(a, M);
  return (int)cudaGetLastError();
}

// quant 0: none; 2: int8; 3: fp8 (quant_kv: the sorted cache too).
template <typename T>
static int launch_quant(const BuildArgs& a, int quant, int quant_kv,
                        cudaStream_t st) {
  if (quant == 0) return quant_kv ? (int)cudaErrorInvalidValue
                                  : launch<T, T, T>(a, st);
  if (quant == 2)
    return quant_kv ? launch<T, int8_t, int8_t>(a, st)
                    : launch<T, int8_t, T>(a, st);
  if (quant == 3)
    return quant_kv ? launch<T, __nv_fp8_e4m3, __nv_fp8_e4m3>(a, st)
                    : launch<T, __nv_fp8_e4m3, T>(a, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (k, v, and the unquantized outputs);
// D a multiple of 16 and every tensor 16-byte aligned (the 16-byte copies
// and stores).
extern "C" int segment_build_launch(
    const void* k, const void* v, const int* perm, void* k_sorted,
    void* v_sorted, void* k_syn, void* v_syn, float* counts,
    float* k_syn_scale, float* v_syn_scale, float* k_scale, float* v_scale,
    int N, int Hkv, int S, int D, int C, int dtype, int quant, int quant_kv,
    void* stream) {
  const BuildArgs a{k, v, perm, k_sorted, v_sorted, k_syn, v_syn, counts,
                    k_syn_scale, v_syn_scale, k_scale, v_scale,
                    N, Hkv, S, D, C, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_quant<__nv_bfloat16>(a, quant, quant_kv, st);
  if (dtype == 0) return launch_quant<float>(a, quant, quant_kv, st);
  return (int)cudaErrorInvalidValue;
}
