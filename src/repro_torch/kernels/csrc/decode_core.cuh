// The decode core shared by flash_decode.cu, block_gather.cu and
// fused_synopsis.cu: one block streams one chunk of key/value rows (a
// contiguous span: a flash_decode chunk of the cache, one selected cluster,
// a chunk of the extras, or a chunk of the centroid tables) for
// one query group of G <= GMAX heads, and leaves the chunk's unnormalised
// online-softmax partial (acc, m, l) to the kernel's epilogue; the last
// block of a (b, hkv) row to finish (an atomic ticket) merges the chunks'
// partials exactly (merge_if_last).
//
// What bounds the work on the H100: bytes.  At G = 4 a key/value row costs
// ~2 flops per byte, ~50x below the tensor-core line, so the arithmetic
// stays on the CUDA cores in f32 and the design is about keeping bytes in
// flight:
//
//  * Loads: each of the block's WARPS warps walks its own tiles of the
//    chunk (tiles w, w + WARPS, ...) through its own ring of STAGES slots
//    (one: see STAGES) in shared memory, filled with cp.async 16-byte
//    copies (.cg: L2 only, the rows are read once).  A tile is ROWS whole rows, at most 4 KB of K
//    and 4 KB of V, so the copy of a tile is one flat byte range per
//    tensor and each lane issues the same number of copies whatever D and
//    the storage type; rows past the chunk's end are zero-filled by the
//    copy itself (src-size 0).  cp.async and not TMA: a chunk is a
//    contiguous span, so no tensor map is needed to address it, and a
//    tensor map would have to be encoded on the host for every tensor of
//    every launch, in a decode loop that is already bound by host work.
//    While a warp computes, the tiles of the SM's other warps are in
//    flight (and its own next STAGES - 1).
//  * Logits: lane l takes the l-th 128-byte segment of the tile's K: half
//    a row of bf16 at D = 128 (a quarter of f32, a whole int8 / fp8 row,
//    several rows at small D), against the G query rows staged in f32 in
//    shared memory (read as float4; the lanes of one row read distinct
//    columns, the others broadcast).  The K slot carries 16 bytes of
//    padding after every segment, so the 8 lanes of a 16-byte load phase
//    read 8 distinct bank groups (unpadded 256-byte bf16 rows would put
//    them all on the same banks); the lanes that share a row add their
//    partial dots with one or two shuffles, and each logit is computed
//    once, by one lane.  The logits of a tile go to a small per-warp
//    buffer p_s [ROWS][GB].
//  * Softmax: the tile's ROWS x GB logits are spread over the warp with
//    head g = lane % GB fixed per lane, so one shuffle tree over the lane
//    bits above log2(GB) takes every head's max and sum at once.  State
//    (m, l) is per head and warp-wide; acc is rescaled once a tile.
//  * p.V: lane l owns COLS = 8 contiguous columns of a row (16 bytes of
//    bf16, 8 of int8 / fp8, 32 of f32): LPR = D / 8 lanes cover a row and
//    a warp step RPI = 32 / LPR rows (consecutive lanes, consecutive
//    bytes of the unpadded V slot), with the row's GB weights read from
//    p_s as float4 broadcasts and acc[GB][8] in registers.  The row groups
//    of a warp are combined once, at the end of the chunk, and the warps of
//    the block once after that, through shared memory that reuses the
//    rings.
//  * Heads: G is rounded up to a bucket GB of 4, 8 or 16 (a template
//    argument), so the loops over heads are unrolled without branches;
//    the heads past G carry a zero query and are masked.  Every bucket
//    reads a tile's K and V from device memory once for all G heads (the
//    logit and p.V passes run over the tile staged in shared memory).  At
//    GB = 16 (command-r-plus's G = 12) a lane's softmax head is lane % 16,
//    so the shuffle tree over the heads' rows is one step (offset 16), and
//    acc[16][8] is 128 f32 registers a lane: there bf16 rows of
//    flash_decode and block_gather take the tensor-core stream of
//    decode_mma.cuh instead (CudaCore below is this stream's side of the
//    choice), and f32 rows, int8 / fp8 caches and stage 1 stay here.
//
// Masking follows the reference: a logit the caller sets to the -1e30
// sentinel takes part in the softmax like any other (an all-masked span
// gives exp(0) = 1 per row, which any finite maximum elsewhere wipes out
// in the merge); rows past the end of the chunk do not exist and are
// skipped.  Partials are stored unnormalised: a chunk's l may cancel to ~0
// or go negative once block_gather's decrement term is folded in.
#pragma once

#include <cuda_fp16.h>

#include "attn_common.cuh"

namespace dc {

constexpr int WARPS = 4;   // warps a block
// Ring slots a warp: one.  A block then takes ~37 KB of shared memory at
// D = 128 in bf16, so an SM holds five blocks (20 warps) and the loads of
// some warps overlap the arithmetic of others; two and three slots a warp
// measured slower on the H100 (fewer blocks an SM: three and two).
constexpr int STAGES = 1;
constexpr int COLS = 8;            // columns a lane owns in p.V
constexpr int TILE_BYTES = 4096;   // bytes of K (and of V) a tile, at most
constexpr int MAX_TILE_ROWS = 64;
constexpr int SEG = 128;  // bytes of a K tile one lane takes for the logits
constexpr int PAD = 16;   // bytes of padding after each segment of a K slot

// Geometry of a tile of rows of type TK and width D, for GB heads.
template <typename TK, int D, int GB>
struct Tile {
  static constexpr int ROW_BYTES = D * (int)sizeof(TK);
  static constexpr int ROWS = TILE_BYTES / ROW_BYTES < MAX_TILE_ROWS
                                  ? TILE_BYTES / ROW_BYTES
                                  : MAX_TILE_ROWS;
  static constexpr int BYTES = ROWS * ROW_BYTES;  // of K, and of V
  static constexpr int SEGS = BYTES / SEG;        // lanes of the logit pass
  static constexpr int KSLOT = BYTES + SEGS * PAD;
  static constexpr int SLOT = KSLOT + BYTES;      // K (padded), then V
  // Logit pass: lanes a row, rows a lane, and a row's elements a lane.
  static constexpr int LPS = ROW_BYTES > SEG ? ROW_BYTES / SEG : 1;
  static constexpr int NR = ROW_BYTES < SEG ? SEG / ROW_BYTES : 1;
  static constexpr int PIECE = (ROW_BYTES < SEG ? ROW_BYTES : SEG) /
                               (int)sizeof(TK);
  // q in shared memory: GB rows of D floats, 16 bytes of padding after
  // each PIECE columns (the lanes of one row read distinct banks).
  static constexpr int QS = D + (D / PIECE) * 4;
  // p.V pass: lanes a row, rows a warp step.
  static constexpr int LPR = D / COLS;
  static constexpr int RPI = 32 / LPR;
  static constexpr int COPIES = BYTES / 16 / 32;  // cp.async a lane a tensor
  static constexpr int NE = (ROWS * GB + 31) / 32;  // softmax entries a lane
  static constexpr int RING_BYTES = STAGES * SLOT;  // one warp's ring
  static constexpr int P_FLOATS = ROWS * GB;        // one warp's logits
  static_assert(D % COLS == 0 && LPR <= 32, "D must be 16 .. 256");
  static_assert(ROWS % RPI == 0, "a tile must be whole warp steps");
  static_assert(BYTES % (16 * 32) == 0, "a tile must be whole warp copies");
  static_assert(BYTES % SEG == 0 && SEGS <= 32, "whole segments, one a lane");
  static_assert(LPS == 1 || SEGS == 32, "shared rows fill the warp");
  static_assert(PIECE % COLS == 0, "a piece is whole 8-element reads");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 consecutive elements of shared memory, widened to f32.
__device__ __forceinline__ void smem8(const float* p, float (&o)[COLS]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void smem8(const __nv_bfloat16* p,
                                      float (&o)[COLS]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void smem8(const int8_t* p, float (&o)[COLS]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (float)(int8_t)(t.x >> (8 * i));
    o[4 + i] = (float)(int8_t)(t.y >> (8 * i));
  }
}
__device__ __forceinline__ void smem8(const __nv_fp8_e4m3* p,
                                      float (&o)[COLS]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {t.x, t.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // exact: e4m3 -> f16 -> f32
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w[i / 2] >> (16 * (i % 2))), __NV_E4M3));
    const float2 f = __half22float2(h);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The GB weights of a row in p_s (16-byte aligned), as float4 reads.
template <int GB>
__device__ __forceinline__ void smem_heads(const float* p, float (&o)[GB]) {
#pragma unroll
  for (int i = 0; i < GB; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    o[i] = a.x; o[i + 1] = a.y; o[i + 2] = a.z; o[i + 3] = a.w;
  }
}

// Stage the G query rows at qb in shared memory as f32, in Tile's padded
// layout (rows G .. GB - 1 zero).  The caller syncs the block before use.
template <typename T, typename TK, int D, int GB>
__device__ __forceinline__ void stage_q(const T* qb, int G, float* q_s) {
  using S = Tile<TK, D, GB>;
  for (int i = threadIdx.x; i < GB * D; i += blockDim.x) {
    const int g = i / D, c = i % D;
    q_s[g * S::QS + c + (c / S::PIECE) * 4] =
        g < G ? to_f(qb[g * D + c]) : 0.f;
  }
}

// One warp's online-softmax state.  m and l are those of head g = lane %
// GB (every lane of that head holds the same values); acc holds the
// lane's 8 columns of every head, summed over the rows of its row group
// until block_merge() adds the row groups.
template <int GB>
struct WarpState {
  float m = NEG_INF_F, l = 0.f;
  float acc[GB][COLS] = {};
};

// Copy rows [r0, r0 + ROWS) of the chunk (k, v: its first row, n rows)
// into a slot (K padded after each segment); rows >= n are zero-filled.
template <typename TK, int D, int GB>
__device__ __forceinline__ void issue_tile(char* slot, const TK* k,
                                           const TK* v, int r0, int n,
                                           int lane) {
  using S = Tile<TK, D, GB>;
  const char* kb = reinterpret_cast<const char*>(k) + (size_t)r0 * S::ROW_BYTES;
  const char* vb = reinterpret_cast<const char*>(v) + (size_t)r0 * S::ROW_BYTES;
  const int valid = min(S::BYTES, (n - r0) * S::ROW_BYTES);
#pragma unroll
  for (int i = 0; i < S::COPIES; ++i) {
    const int off = (i * 32 + lane) * 16;
    const bool ok = off < valid;
    cp_async16(slot + off + (off / SEG) * PAD,
               ok ? kb + off : reinterpret_cast<const char*>(k), ok ? 16 : 0);
    cp_async16(slot + S::KSLOT + off,
               ok ? vb + off : reinterpret_cast<const char*>(v), ok ? 16 : 0);
  }
}

// The per-row hooks of stream_chunk that flash_decode and block_gather do
// without: they compile to nothing.
struct NoRowHook {  // on_row(x, r): row r's raw dots x[g] of all GB heads
  template <int GB>
  __device__ __forceinline__ void operator()(const float (&)[GB], int) const {}
};
struct NoPScale {   // pscale(p, r): row r's weight p as it enters p.V
  __device__ __forceinline__ float operator()(float p, int) const {
    return p;
  }
};

// This warp's share of rows [0, n) of the chunk at (k, v) (tiles warp,
// warp + WARPS, ...), into st.  q_s: the block's query rows (stage_q);
// logit(raw, r) turns row r's raw dot q.k of one head into its logit
// (scale, softcap, bias or sentinel); it is called only for rows r < n and
// heads g < G.  on_row(x, r) is called once for every row r < n, by one
// lane, with the row's raw dots of all GB heads (heads past G hold 0);
// pscale(p, r) weighs row r's p on its way into p.V after p was added to
// l (a per-row value scale), for rows r < n.  ring: this warp's
// Tile::RING_BYTES; p_s: its Tile::P_FLOATS.
template <typename TK, int D, int GB, typename Logit,
          typename RowHook = NoRowHook, typename PScale = NoPScale>
__device__ __forceinline__ void stream_chunk(
    const TK* k, const TK* v, int n, int G, const float* q_s,
    const Logit& logit, char* ring, float* p_s, WarpState<GB>& st,
    const RowHook& on_row = RowHook(), const PScale& pscale = PScale()) {
  using S = Tile<TK, D, GB>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (n + S::ROWS - 1) / S::ROWS;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
  // Logit pass: this lane's segment, its first row and its columns.
  const int piece = S::LPS > 1 ? lane % S::LPS : 0;
  const int lrow = S::LPS > 1 ? lane / S::LPS : lane * S::NR;
  const float* qp = q_s + piece * (S::PIECE + 4);
  // p.V pass: this lane's columns and row group.
  const int c0 = (lane % S::LPR) * COLS;
  const int rsub = lane / S::LPR;
  const int g_own = lane % GB;

#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < mine)
      issue_tile<TK, D, GB>(ring + s * S::SLOT, k, v,
                            (warp + s * WARPS) * S::ROWS, n, lane);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    char* slot = ring + (i % STAGES) * S::SLOT;
    const TK* vt = reinterpret_cast<const TK*>(slot + S::KSLOT);
    const int r0 = (warp + i * WARPS) * S::ROWS;

    // Logits of the tile's rows into p_s[row * GB + g].
    if (lane < S::SEGS) {
      const TK* ks = reinterpret_cast<const TK*>(slot + lane * (SEG + PAD));
#pragma unroll
      for (int rr = 0; rr < S::NR; ++rr) {
        float x[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) x[g] = 0.f;
#pragma unroll
        for (int e0 = 0; e0 < S::PIECE; e0 += COLS) {
          float kr[COLS];
          smem8(ks + rr * D + e0, kr);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            float qv[COLS];
            smem8(qp + g * S::QS + e0, qv);
#pragma unroll
            for (int e = 0; e < COLS; ++e) x[g] = fmaf(qv[e], kr[e], x[g]);
          }
        }
#pragma unroll
        for (int o = S::LPS / 2; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < GB; ++g)
            x[g] += __shfl_xor_sync(0xffffffffu, x[g], o);
        const int row = lrow + rr;
        const bool ok = r0 + row < n;
        // Head g of the row is written by the lane with piece g % LPS.
#pragma unroll
        for (int t = 0; t < (GB + S::LPS - 1) / S::LPS; ++t) {
          const int g = piece + S::LPS * t;
          float xv = x[0];
#pragma unroll
          for (int h = 1; h < GB; ++h)
            if (h == g) xv = x[h];
          if (g < GB)
            p_s[row * GB + g] = (ok && g < G) ? logit(xv, r0 + row)
                                              : NEG_INF_F;
        }
        if (ok && piece == 0) on_row(x, r0 + row);
      }
    }
    __syncwarp();

    // Online softmax over the tile: entry f = lane + 32 * t is row f / GB
    // of head g_own.
    float xs[S::NE];
    bool live[S::NE];
    float mx = NEG_INF_F;
#pragma unroll
    for (int t = 0; t < S::NE; ++t) {
      const int f = lane + 32 * t;
      live[t] = f < S::ROWS * GB && r0 + f / GB < n && g_own < G;
      xs[t] = live[t] ? p_s[f] : NEG_INF_F;
      mx = fmaxf(mx, xs[t]);
    }
#pragma unroll
    for (int o = GB; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(st.m, mx);
    const float alpha = __expf(st.m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int t = 0; t < S::NE; ++t) {
      const int f = lane + 32 * t;
      const float p = live[t] ? __expf(xs[t] - m_new) : 0.f;
      if (f < S::ROWS * GB) p_s[f] = live[t] ? pscale(p, r0 + f / GB) : p;
      ps += p;
    }
#pragma unroll
    for (int o = GB; o < 32; o <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    st.l = st.l * alpha + ps;
    st.m = m_new;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float a = __shfl_sync(0xffffffffu, alpha, g);
#pragma unroll
      for (int e = 0; e < COLS; ++e) st.acc[g][e] *= a;
    }
    __syncwarp();

    // p.V; rows past n carry p = 0 and zero-filled values.
#pragma unroll
    for (int j0 = 0; j0 < S::ROWS; j0 += S::RPI) {
      const int j = j0 + rsub;
      float vr[COLS];
      smem8(vt + j * D + c0, vr);
      float p[GB];
      smem_heads<GB>(p_s + j * GB, p);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < COLS; ++e)
          st.acc[g][e] = fmaf(p[g], vr[e], st.acc[g][e]);
    }
    __syncwarp();
    if (i + STAGES < mine)
      issue_tile<TK, D, GB>(slot, k, v,
                            (warp + (i + STAGES) * WARPS) * S::ROWS, n, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

template <int A, int B>
struct Max {
  static constexpr int value = A > B ? A : B;
};

// Dynamic shared memory of a block whose spans are rows of TA or TB:
// WARPS rings of the larger tiles (the merge reuses them), then the
// warps' logits buffers, then the staged query rows.
template <typename TA, typename TB, int D, int GB>
struct Smem {
  using A = Tile<TA, D, GB>;
  using B = Tile<TB, D, GB>;
  static constexpr int RING = Max<A::RING_BYTES, B::RING_BYTES>::value;
  static constexpr int P = Max<A::P_FLOATS, B::P_FLOATS>::value;
  static constexpr int Q = Max<A::QS, B::QS>::value * GB;
  static constexpr int MERGE = (int)sizeof(float) * WARPS * GB * (D + 2);
  static constexpr int P_OFF = Max<WARPS * RING, MERGE>::value;
  static constexpr int Q_OFF = P_OFF + (int)sizeof(float) * WARPS * P;
  static constexpr int BYTES = Q_OFF + (int)sizeof(float) * Q;

  __device__ static char* ring(char* smem) {
    return smem + (threadIdx.x >> 5) * RING;
  }
  __device__ static float* p_s(char* smem) {
    return reinterpret_cast<float*>(smem + P_OFF) + (threadIdx.x >> 5) * P;
  }
  __device__ static float* q_s(char* smem) {
    return reinterpret_cast<float*>(smem + Q_OFF);
  }
};

// The block's NW partials, left in shared memory as m and l [NW][GB] and
// acc [NW][GB][D] (floats from smem on), merged exactly: calls finish(g,
// d, m, l, acc) for every g < G and d < D.  The caller syncs the block
// after writing them.  From GB = 8 on, each head's m, l and the partials'
// weights exp(m_w - m) are taken once, by one thread a head (the weights
// over m's slots), so that an output costs NW loads and FMAs.  At GB = 4 a
// thread's outputs lie in different heads, so each output takes its own
// weights and the barrier goes: on the H100 that made llama3-8b's G = 4
// flash_decode 1 us faster a call, where the shared weights made
// arctic-480b's G = 7 block_gather 1.5 us faster (PERF.md §6).
template <int D, int GB, int NW, typename Finish>
__device__ __forceinline__ void combine_warps(int G, char* smem,
                                              const Finish& finish) {
  float* wm = reinterpret_cast<float*>(smem);
  const float* wl = wm + NW * GB;
  const float* wacc = wl + NW * GB;
  if constexpr (GB <= 4) {
    for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
      const int g = t / D, d = t % D;
      float m = NEG_INF_F;
#pragma unroll
      for (int w = 0; w < NW; ++w) m = fmaxf(m, wm[w * GB + g]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float sc = expf(wm[w * GB + g] - m);
        l = fmaf(wl[w * GB + g], sc, l);
        a = fmaf(wacc[(w * GB + g) * D + d], sc, a);
      }
      finish(g, d, m, l, a);
    }
  } else {
    __shared__ float head_m[GB], head_l[GB];
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      float m = NEG_INF_F;
#pragma unroll
      for (int w = 0; w < NW; ++w) m = fmaxf(m, wm[w * GB + g]);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float sc = expf(wm[w * GB + g] - m);
        l = fmaf(wl[w * GB + g], sc, l);
        wm[w * GB + g] = sc;
      }
      head_m[g] = m;
      head_l[g] = l;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
      const int g = t / D, d = t % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        a = fmaf(wacc[(w * GB + g) * D + d], wm[w * GB + g], a);
      finish(g, d, head_m[g], head_l[g], a);
    }
  }
}

// Merge the block's warps into one partial per (head, column): calls
// finish(g, d, m, l, acc) for every g < G and d < D, with the chunk's
// unnormalised acc.  Every warp must have left its ring (the merge reuses
// the rings' memory); syncs the block.
template <int D, int GB, typename Finish>
__device__ __forceinline__ void block_merge(WarpState<GB>& st, int G,
                                            char* smem, const Finish& finish) {
  constexpr int LPR = D / COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The row groups of the warp share m and l: add their acc.
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < COLS; ++e)
        st.acc[g][e] += __shfl_xor_sync(0xffffffffu, st.acc[g][e], o);
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [WARPS][GB]
  float* wl = wm + WARPS * GB;                 // [WARPS][GB]
  float* wacc = wl + WARPS * GB;               // [WARPS][GB][D]
  if (lane < GB) {
    wm[warp * GB + lane] = st.m;
    wl[warp * GB + lane] = st.l;
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < COLS; ++e)
        wacc[(warp * GB + g) * D + lane * COLS + e] = st.acc[g][e];
  }
  __syncthreads();
  combine_warps<D, GB, WARPS>(G, smem, finish);
}

// The output of a (head, column): acc / l, with flash_decode's rule
// (l >= 0 always: clamp) or block_gather's (l may cancel or go negative:
// divide only where |l| > 1e-30).
template <bool SIGNED>
__device__ __forceinline__ float normalise(float a, float l) {
  return SIGNED ? a / (fabsf(l) > 1e-30f ? l : 1.f) : a / fmaxf(l, 1e-30f);
}

// The exact merge of a (b, hkv) row's nparts chunk partials (row-major
// (rows, nparts, D) / (rows, nparts), rows row0 .. row0 + G - 1), by the
// last block of the row to finish: every block calls it after writing its
// partial; the block that takes the last ticket merges and resets the
// ticket to 0 for the next launch (so launches that share the tickets must
// run one after another, as on one stream).  m is the max, l the sum of
// l_s * exp(m_s - m) (signed for block_gather; taken in one pass over the
// parts, rescaled as m grows), o the same sum of the partials' acc,
// normalised.  The partials of other blocks are read from
// L2 (__ldcg, as float4s), after the fences of the ticket.  The weights
// exp(m_s - m) go to shared memory (w: cap floats, free once the block has
// merged its warps), so that each thread keeps the loads of its GB * D /
// 512 float4 outputs, for four parts at a time, in flight together.
template <bool SIGNED, int D, int GB>
__device__ __forceinline__ void merge_if_last(
    unsigned* ticket, int nparts, int G, size_t row0,
    const float* o_part, const float* m_part, const float* l_part, float* o,
    float* m_out, float* l_out, float* w, int cap) {
  constexpr int THREADS = WARPS * 32;
  constexpr int V = D / 4;                              // float4s a row
  constexpr int IT = (GB * V + THREADS - 1) / THREADS;  // float4s a thread
  __shared__ bool last;
  __shared__ float red_m[GMAX], red_l[GMAX];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)nparts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  {  // m and l: HT threads a head, every head at once, in one pass (each
     // thread's parts, then its head's threads, merged online)
    constexpr int HT = THREADS / GB;
    const int g = threadIdx.x / HT, sub = threadIdx.x % HT;
    const float* mp = m_part + (row0 + g) * nparts;
    const float* lp = l_part + (row0 + g) * nparts;
    float mx = NEG_INF_F, ls = 0.f;
    if (g < G) {
#pragma unroll 4
      for (int s = sub; s < nparts; s += HT) {
        const float ms = __ldcg(mp + s), mn = fmaxf(mx, ms);
        ls = ls * expf(mx - mn) + __ldcg(lp + s) * expf(ms - mn);
        mx = mn;
      }
    }
#pragma unroll
    for (int o = HT / 2; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mx, o);
      const float lo = __shfl_xor_sync(0xffffffffu, ls, o);
      const float mn = fmaxf(mx, mo);
      ls = ls * expf(mx - mn) + lo * expf(mo - mn);
      mx = mn;
    }
    if (g < G && sub == 0) {
      red_m[g] = mx;
      red_l[g] = ls;
    }
  }
  float4 a[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) a[it] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int chunk = cap / G;  // parts whose weights fit at once
  for (int s0 = 0; s0 < nparts; s0 += chunk) {
    const int ns = min(chunk, nparts - s0);
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < G * ns; i += THREADS) {
      const int g = i / ns, s = s0 + i % ns;
      w[i] = expf(__ldcg(m_part + (row0 + g) * nparts + s) - red_m[g]);
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int t = threadIdx.x + it * THREADS;
        if (t < G * V) {
          const int g = t / V;
          const float4 x = __ldcg(
              reinterpret_cast<const float4*>(
                  o_part + ((row0 + g) * nparts + s0 + s) * D) +
              t % V);
          const float wt = w[g * ns + s];
          a[it].x = fmaf(x.x, wt, a[it].x);
          a[it].y = fmaf(x.y, wt, a[it].y);
          a[it].z = fmaf(x.z, wt, a[it].z);
          a[it].w = fmaf(x.w, wt, a[it].w);
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int t = threadIdx.x + it * THREADS;
    if (t < G * V) {
      const int g = t / V, d = (t % V) * 4;
      const float l = red_l[g];
      *reinterpret_cast<float4*>(o + (row0 + g) * D + d) = make_float4(
          normalise<SIGNED>(a[it].x, l), normalise<SIGNED>(a[it].y, l),
          normalise<SIGNED>(a[it].z, l), normalise<SIGNED>(a[it].w, l));
      if (d == 0) {
        m_out[row0 + g] = red_m[g];
        l_out[row0 + g] = l;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// The CUDA-core stream as the kernels take it: one of the two routes of
// flash_decode.cu and block_gather.cuh (the other, the tensor-core stream
// of decode_mma.cuh, has the same members).  Spans of rows of TA or TB
// (block_gather: the cache's and the extras' types), a head bucket of GB.
template <typename TA, typename TB, int D, int GB_>
struct CudaCore {
  static constexpr int GB = GB_;
  // No minimum of blocks an SM in the kernels' launch bounds (0 emits
  // none): with a minimum of 1 ptxas gave the bucket of 4 128 registers a
  // thread where it takes 76-96 without one, and llama3-8b's 544 stage-2
  // blocks no longer fit one wave (PERF.md §6).
  static constexpr int MIN_BLOCKS = 0;
  using Sm = Smem<TA, TB, D, GB>;
  using State = WarpState<GB>;
  static constexpr int SMEM = Sm::BYTES;
  static constexpr int SCRATCH = Sm::P_OFF / 4;  // floats merge_if_last reuses
  // Stage the query rows at qb for spans of TR rows; the caller syncs.
  template <typename TR, typename T>
  __device__ static void stage(const T* qb, int G, char* smem) {
    stage_q<T, TR, D, GB>(qb, G, Sm::q_s(smem));
  }
  template <typename TR, typename Logit>
  __device__ static void stream(const TR* k, const TR* v, int n, int G,
                                const Logit& logit, char* smem, State& st) {
    stream_chunk<TR, D, GB>(k, v, n, G, Sm::q_s(smem), logit, Sm::ring(smem),
                            Sm::p_s(smem), st);
  }
  template <typename Finish>
  __device__ static void merge(State& st, int G, char* smem,
                               const Finish& finish) {
    block_merge<D, GB>(st, G, smem, finish);
  }
};

// Runs the statements (which must return) with `constexpr int kGB` the
// head bucket of G (4, 8 or 16).
#define DISPATCH_HEAD_BUCKET(G, ...)                          \
  if ((G) <= 4) { constexpr int kGB = 4; __VA_ARGS__ }        \
  else if ((G) <= 8) { constexpr int kGB = 8; __VA_ARGS__ }   \
  else { constexpr int kGB = 16; __VA_ARGS__ }

}  // namespace dc
