// The decode core's tensor-core stream: what stream_chunk and block_merge
// of decode_core.cuh compute, for one (b, hkv) group of G <= 16 heads over
// bf16 rows, with the products on mma.sync.  flash_decode.cu and
// block_gather.cuh take it for bf16 rows of a group in the head bucket of
// 16 (command-r-plus's G = 12); the wrappers choose the route before the
// launch (_build.decode_mma).  The grid, the chunks, the tickets, the
// epilogues and the merges stay the decode core's.
//
// Why a stream of its own: at G = 4 a key/value row costs ~2 flops per
// byte and the CUDA cores keep up; in the bucket of 16 it is 3x that, and
// the CUDA-core loops ran out of registers (acc[16][8], 128 f32 a lane,
// 255 a thread, two blocks an SM) and were bound by shared-memory reads of
// the f32 query, which every K piece read once per head.  A group's 16
// query rows are exactly one m16n8k16 M tile, so a tile's logits S = Q K^T
// (D / 16 k steps x 2 n8 tiles) and its P V (one k16 step x D / 8 n8
// tiles) are a handful of mma.sync a warp.
//
//  * Numbers.  The query shares K / V's type (bf16: _build.dtype_code), so
//    q x k products are exact in the f32 accumulator and no split of the
//    query is needed.  P is split into bf16 hi + lo (hi = bf16(p), lo =
//    bf16(p - hi)) and both halves go through P V, as latent_mma.cuh does:
//    the card tests' bf16 tolerance of 1e-3 holds without loosening it.
//  * Query.  Staged once a block in shared memory as a 16-row bf16 tile
//    (rows past G zero); a warp reads its A fragments with ldmatrix at
//    each k step.  Holding all D / 16 of them in registers (32 at D = 128)
//    would cost the registers that a fifth block an SM needs (below).
//  * Tiles.  K and V come in the decode core's tiles (4 KB of each at D <=
//    128: 16 rows at D = 128, so _build.decode_tile_rows and flash_decode's
//    chunks keep their meaning; 16 rows, 8 KB, at D = 256), one tile a team
//    of warps (below) in its own ring of ST slots (each kernel's, as
//    measured: two for flash_decode's long chunks, one for block_gather's
//    clusters of 128 rows), by cp.async 16-byte copies (.cg; rows
//    past the span zero-filled by the copy).  cp.async and not TMA, for
//    decode_core.cuh's reason: a span is contiguous and a tensor map would
//    be encoded on the host for every launch.  In shared memory each row is
//    padded by 16 bytes (pitch D * 2 + 16, an odd number of 16-byte
//    units), so the 8 row addresses of an ldmatrix phase fall on 8
//    distinct bank groups: ldmatrix reads K for the logits' B operand and
//    ldmatrix.trans reads V for P V's, without conflicts.  A tile of more
//    than 16 rows (D < 128) is taken as 16-row steps.
//  * Softmax on the accumulator fragment.  A thread holds heads lane / 4
//    and lane / 4 + 8, at 4 rows of the step; each kernel's logit functor
//    (scale, softcap, bias, sentinel, validity) is applied in place, a
//    head's max and sum are taken over its quad with two shuffles, and the
//    fragment's P becomes P V's A operand in registers, with no round trip
//    through shared memory.  The sentinel semantics are decode_core.cuh's:
//    m starts at -1e30, a logit at the sentinel takes part like any other,
//    rows past the span and heads past G have p = 0.
//  * O and registers.  O is 16 x D f32 in mma accumulators: D / 8 n8
//    tiles of 4 floats a thread, 64 registers at D = 128.  With them a
//    thread took 128 registers and spilled, and four blocks an SM leave
//    block_gather's 544 blocks at command-r-plus's shape (32 clusters + 2
//    extras chunks x 16 (b, hkv)) a second wave of 16.  So a warp keeps at
//    most 64 of O's columns (32 registers): at D = 128 the block's warps
//    pair up, and at D = 256 all four take one tile.  The warps of a team
//    read the same tile from one ring (copied by all of them, a named
//    barrier around it), each computes the whole S (the logits' mma twice
//    or four times: still far below the bytes) and keeps its own columns
//    of O; a thread then fits in 96 registers, five blocks an SM.
//  * Merges.  Each team's first warp leaves m and l (its team holds the
//    same), and every warp its O columns, in shared memory in the decode
//    core's layout, and combine_warps merges the teams; the epilogues, the
//    partials and merge_if_last are the decode core's.
#pragma once

#include <type_traits>

#include "decode_core.cuh"

namespace dm {

using bf16 = __nv_bfloat16;
constexpr int WARPS = dc::WARPS;
constexpr int M = 16;    // heads: one mma M tile
constexpr int K16 = 16;  // rows of a step: P V's one k16

// Geometry of the stream at head dim D with ST ring slots a team of warps
// (the warps that read one tile).
template <int D, int ST>
struct Geo {
  static constexpr int ROW_BYTES = D * 2;
  static constexpr int PITCH = ROW_BYTES + 16;     // a row in shared memory
  // Warps sharing a tile, each with 64 of O's columns (all of them at D <=
  // 64).
  static constexpr int CSPLIT = D > 64 ? D / 64 : 1;
  static constexpr int TEAMS = WARPS / CSPLIT;
  // The decode core's tile (dc::Tile), at least one k16 step.
  static constexpr int CORE_ROWS =
      dc::TILE_BYTES / ROW_BYTES < dc::MAX_TILE_ROWS
          ? dc::TILE_BYTES / ROW_BYTES
          : dc::MAX_TILE_ROWS;
  static constexpr int ROWS = CORE_ROWS > K16 ? CORE_ROWS : K16;
  static constexpr int STEPS = ROWS / K16;
  static constexpr int BYTES = ROWS * ROW_BYTES;  // of K (and V) a tile
  static constexpr int TSLOT = ROWS * PITCH;      // of K (and V) in a slot
  static constexpr int SLOT = 2 * TSLOT;          // K, then V
  static constexpr int RING = ST * SLOT;          // a team's ring
  static constexpr int COPIES = BYTES / 16 / (32 * CSPLIT);  // a thread
  static constexpr int DW = D / CSPLIT;           // O's columns a warp
  static constexpr int NT = DW / 8;               // O's n8 tiles a warp
  static constexpr int KS = D / 16;               // the logits' k steps
  // Shared memory: the rings (the merge's m, l and O reuse them), then the
  // query tile.
  static constexpr int MERGE = (int)sizeof(float) * TEAMS * M * (D + 2);
  static constexpr int Q_OFF = dc::Max<TEAMS * RING, MERGE>::value;
  static constexpr int SMEM = Q_OFF + M * PITCH;
  static_assert(D % 16 == 0 && NT % 2 == 0, "D must be 16 .. 256");
  static_assert(ROWS % K16 == 0, "a tile must be whole k16 steps");
  static_assert(BYTES % (16 * 32 * CSPLIT) == 0, "whole copies a thread");
  static_assert((WARPS % CSPLIT == 0 && TEAMS <= 2) || CSPLIT == 1,
                "whole teams, at most two of more than one warp");
};

// One warp's online-softmax state: m and l of heads lane / 4 and lane / 4
// + 8 (each quad holds the same values), and its O columns as mma
// accumulator fragments.
template <int D, int ST>
struct State {
  float m[2] = {NEG_INF_F, NEG_INF_F};
  float l[2] = {0.f, 0.f};
  float o[Geo<D, ST>::NT][4] = {};
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(dc::smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(dc::smem_addr(p))
      : "memory");
}
// d += a b: one m16n8k16, bf16 in, f32 accumulated.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (a, b) = hi + lo as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - f.x, b - f.y));
}

// The warps that read one tile: the warp itself, or its team (a named
// barrier of its own, ids 1 .. TEAMS, or __syncthreads' 0 for all four
// warps).  The ids are constants: with an id in a register ptxas reserves
// all 16 barriers, and the card then started 16 of block_gather's 544
// blocks in a second wave.
template <int CSPLIT>
__device__ __forceinline__ void team_sync(int team) {
  constexpr int N = 32 * CSPLIT;
  if (CSPLIT == 1)
    __syncwarp();
  else if (CSPLIT == WARPS)
    __syncthreads();
  else if (team == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(N) : "memory");
}

// Stage the G query rows at qb (16-byte aligned) as the block's bf16 tile
// (rows G .. 15 zero, rows padded to PITCH), 16 bytes a copy; the caller
// syncs the block.
template <int D, int ST>
__device__ __forceinline__ void stage_q(const bf16* qb, int G, char* smem) {
  using Gm = Geo<D, ST>;
  constexpr int PIECES = Gm::ROW_BYTES / 16;  // 16-byte pieces a row
  char* q_s = smem + Gm::Q_OFF;
#pragma unroll
  for (int i0 = 0; i0 < M * PIECES; i0 += WARPS * 32) {
    const int i = i0 + threadIdx.x, g = i / PIECES;
    if (i < M * PIECES)
      *reinterpret_cast<uint4*>(q_s + g * Gm::PITCH + i % PIECES * 16) =
          g < G ? __ldg(reinterpret_cast<const uint4*>(qb) + i)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Copy rows [r0, r0 + ROWS) of the span (k, v: its first row, n rows) into
// a slot, rows padded to PITCH; rows >= n are zero-filled.  tt: the
// thread's index in its team.
template <int D, int ST>
__device__ __forceinline__ void issue_tile(char* slot, const bf16* k,
                                           const bf16* v, int r0, int n,
                                           int tt) {
  using Gm = Geo<D, ST>;
  const size_t row0 = (size_t)r0 * Gm::ROW_BYTES;
  const char* kb = reinterpret_cast<const char*>(k) + row0;
  const char* vb = reinterpret_cast<const char*>(v) + row0;
  const int valid = min(Gm::BYTES, (n - r0) * Gm::ROW_BYTES);
#pragma unroll
  for (int i = 0; i < Gm::COPIES; ++i) {
    const int off = (i * 32 * Gm::CSPLIT + tt) * 16;
    const bool ok = off < valid;
    const int dst = (off / Gm::ROW_BYTES) * Gm::PITCH + off % Gm::ROW_BYTES;
    dc::cp_async16(slot + dst,
                   ok ? kb + off : reinterpret_cast<const char*>(k),
                   ok ? 16 : 0);
    dc::cp_async16(slot + Gm::TSLOT + dst,
                   ok ? vb + off : reinterpret_cast<const char*>(v),
                   ok ? 16 : 0);
  }
}

// This warp's share of rows [0, n) of the span at (k, v) (its team's tiles
// team, team + TEAMS, ...), into st; the query tile staged by stage_q.
// logit(raw, r) turns row r's raw dot q.k of one head into its logit; it
// is called only for rows r < n and heads g < G.
template <int D, int ST, typename Logit>
__device__ __forceinline__ void stream(const bf16* k, const bf16* v, int n,
                                       int G, const Logit& logit, char* smem,
                                       State<D, ST>& st) {
  using Gm = Geo<D, ST>;
  constexpr int P = Gm::PITCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / Gm::CSPLIT, member = warp % Gm::CSPLIT;
  const int tt = member * 32 + lane;
  const int ntiles = (n + Gm::ROWS - 1) / Gm::ROWS;
  const int mine =
      ntiles > team ? (ntiles - team + Gm::TEAMS - 1) / Gm::TEAMS : 0;
  char* ring = smem + team * Gm::RING;
  const char* q_s = smem + Gm::Q_OFF;
  // The fragments' heads and the step's rows of this thread.
  const int h0 = lane >> 2, rq = (lane & 3) * 2;
  const bool live0 = h0 < G, live1 = h0 + 8 < G;
  // ldmatrix rows: lanes 8i .. 8i + 7 address matrix i's 8 rows.  Q and V
  // (A; B transposed): matrices (rows 0-7, c), (8-15, c), (0-7, c + 8),
  // (8-15, c + 8); K (B): (rows 0-7, c), (0-7, c + 8), (8-15, c),
  // (8-15, c + 8).
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * P + 16 * (lane >> 4);
  const int b_off = ((lane & 7) + 8 * (lane >> 4)) * P + 16 * ((lane >> 3) & 1);
  const char* qa = q_s + a_off;
  const int v_col = member * Gm::DW * 2;

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (s < mine)
      issue_tile<D, ST>(ring + s * Gm::SLOT, k, v,
                        (team + s * Gm::TEAMS) * Gm::ROWS, n, tt);
    dc::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    dc::cp_async_wait<ST - 1>();
    team_sync<Gm::CSPLIT>(team);
    char* slot = ring + (i % ST) * Gm::SLOT;
    const int r0 = (team + i * Gm::TEAMS) * Gm::ROWS;
#pragma unroll
    for (int j0 = 0; j0 < Gm::STEPS; ++j0) {
      const int rs = r0 + j0 * K16;  // the step's first row in the span
      if (rs >= n) break;
      const char* ks = slot + j0 * K16 * P;
      const char* vs = ks + Gm::TSLOT;

      // S = Q K^T: s[j] holds rows rs + 8 j .. + 7; (d0, d1) head h0 at
      // rows rq, rq + 1, (d2, d3) head h0 + 8.
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < Gm::KS; ++kk) {
        uint32_t a[4], b[4];
        ldsm_x4(a, qa + kk * 32);
        ldsm_x4(b, ks + b_off + kk * 32);
        mma(s[0], a, b[0], b[1]);
        mma(s[1], a, b[2], b[3]);
      }

      // Logits, then the step's online softmax per head (over the quad).
      float mx0 = NEG_INF_F, mx1 = NEG_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = rs + 8 * j + rq + e;
          const bool ok = r < n;
          s[j][e] = ok && live0 ? logit(s[j][e], r) : NEG_INF_F;
          s[j][2 + e] = ok && live1 ? logit(s[j][2 + e], r) : NEG_INF_F;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(st.m[0], mx0), mn1 = fmaxf(st.m[1], mx1);
      const float al0 = __expf(st.m[0] - mn0), al1 = __expf(st.m[1] - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = rs + 8 * j + rq + e < n;
          s[j][e] = ok && live0 ? __expf(s[j][e] - mn0) : 0.f;
          s[j][2 + e] = ok && live1 ? __expf(s[j][2 + e] - mn1) : 0.f;
          ps0 += s[j][e];
          ps1 += s[j][2 + e];
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, o);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, o);
      }
      st.l[0] = st.l[0] * al0 + ps0;
      st.l[1] = st.l[1] * al1 + ps1;
      st.m[0] = mn0;
      st.m[1] = mn1;
#pragma unroll
      for (int t = 0; t < Gm::NT; ++t) {
        st.o[t][0] *= al0;
        st.o[t][1] *= al0;
        st.o[t][2] *= al1;
        st.o[t][3] *= al1;
      }

      // O += P V with P as A fragments straight from s (rows of the step
      // as P's k), in bf16 hi and lo halves; rows past n have p = 0 and
      // zero-filled values.
      uint32_t ph[4], pl[4];
      split(s[0][0], s[0][1], ph[0], pl[0]);
      split(s[0][2], s[0][3], ph[1], pl[1]);
      split(s[1][0], s[1][1], ph[2], pl[2]);
      split(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int t = 0; t < Gm::NT; t += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + a_off + v_col + t * 16);
        mma(st.o[t], ph, b[0], b[1]);
        mma(st.o[t], pl, b[0], b[1]);
        mma(st.o[t + 1], ph, b[2], b[3]);
        mma(st.o[t + 1], pl, b[2], b[3]);
      }
    }
    team_sync<Gm::CSPLIT>(team);
    if (i + ST < mine)
      issue_tile<D, ST>(slot, k, v, (team + (i + ST) * Gm::TEAMS) * Gm::ROWS,
                        n, tt);
    dc::cp_async_commit();
  }
  dc::cp_async_wait<0>();
}

// Merge the block's warps into one partial per (head, column), as
// dc::block_merge does: calls finish(g, d, m, l, acc) for every g < G and
// d < D.  Every warp must have left its ring; syncs the block.
template <int D, int ST, typename Finish>
__device__ __forceinline__ void block_merge(State<D, ST>& st, int G,
                                            char* smem,
                                            const Finish& finish) {
  using Gm = Geo<D, ST>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / Gm::CSPLIT, member = warp % Gm::CSPLIT;
  const int h0 = lane >> 2;
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [TEAMS][M]
  float* wl = wm + Gm::TEAMS * M;              // [TEAMS][M]
  float* wacc = wl + Gm::TEAMS * M;            // [TEAMS][M][D]
  if (member == 0 && (lane & 3) == 0) {
    wm[team * M + h0] = st.m[0];
    wm[team * M + h0 + 8] = st.m[1];
    wl[team * M + h0] = st.l[0];
    wl[team * M + h0 + 8] = st.l[1];
  }
  float* o0 = wacc + (team * M + h0) * D + member * Gm::DW + (lane & 3) * 2;
  float* o1 = o0 + 8 * D;
#pragma unroll
  for (int t = 0; t < Gm::NT; ++t) {
    *reinterpret_cast<float2*>(o0 + 8 * t) = make_float2(st.o[t][0],
                                                         st.o[t][1]);
    *reinterpret_cast<float2*>(o1 + 8 * t) = make_float2(st.o[t][2],
                                                         st.o[t][3]);
  }
  __syncthreads();
  dc::combine_warps<D, M, Gm::TEAMS>(G, smem, finish);
}

// The tensor-core stream as the kernels take it (dc::CudaCore's members):
// bf16 rows and query only.
template <int D, int ST>
struct Core {
  static constexpr int GB = M;
  // Five blocks an SM (block_gather's 544 blocks at command-r-plus's
  // shape in one wave): at most 96 registers a thread.  At D = 256 that
  // cap spills (248 bytes a thread in block_gather, 60 in flash_decode;
  // 168 and 130 registers without it); no model reads D = 256 in this
  // bucket.
  static constexpr int MIN_BLOCKS = 5;
  using State = dm::State<D, ST>;
  static constexpr int SMEM = Geo<D, ST>::SMEM;
  static constexpr int SCRATCH = Geo<D, ST>::Q_OFF / 4;
  template <typename TR, typename T>
  __device__ static void stage(const T* qb, int G, char* smem) {
    static_assert(std::is_same<T, bf16>::value &&
                      std::is_same<TR, bf16>::value,
                  "the tensor-core stream takes bf16 rows and query");
    stage_q<D, ST>(qb, G, smem);
  }
  template <typename TR, typename Logit>
  __device__ static void stream(const TR* k, const TR* v, int n, int G,
                                const Logit& logit, char* smem, State& st) {
    dm::stream<D, ST>(k, v, n, G, logit, smem, st);
  }
  template <typename Finish>
  __device__ static void merge(State& st, int G, char* smem,
                               const Finish& finish) {
    block_merge<D, ST>(st, G, smem, finish);
  }
};

}  // namespace dm
