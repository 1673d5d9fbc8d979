// The latent core's tensor-core kernels: flash_decode and
// block_gather_attention at MLA's absorbed-decode shapes (deepseek-v2: an
// f32 query q_eff of G = 128 heads over one latent head of D = kv_lora +
// rope = 576; 4 and 48 at SMOKE size) on bf16 rows, and block_gather's
// int8 / fp8 e4m3 cache codes (`has_kq`).  f32 rows stay on the CUDA-core
// kernels of latent_core.cuh (the wrappers choose by dtype before the
// launch), and so do the latent fused_synopsis and synopsis_score.
//
// What bounds them on the H100: bytes.  flash_decode over (2, 1, 8192,
// 576) bf16 reads 37.7 MB (0.0113 ms at 3.35 TB/s) and does 4.83 GFLOP of
// attention; the design below issues every product twice (the query and P
// split in two bf16 halves), 9.66 GFLOP, 0.0098 ms at the 989 TFLOP/s of
// the bf16 tensor cores: still under the byte bound, but only just, so the
// design's job is to keep the tensor cores' work at that count and off the
// CUDA cores (latent_core.cuh ran it as f32 FMAs, at 67 TFLOP/s).
//
//  * Numbers.  The query stays f32 (the reference einsum prefers f32, and
//    one bf16 rounding of q_eff moves the logits by ~2^-9 of |q||k|: a
//    different result).  Each block splits its heads' rows once, q = q_hi
//    + q_lo with q_hi = bf16(q) and q_lo = bf16(q - q_hi) (|q - q_hi -
//    q_lo| <= 2^-17 |q|), and issues both halves against the same K tile:
//    products of bf16 values are exact in f32 and sum in the wgmma's f32
//    accumulator.  P is split the same way for P.V (as flash_prefill.cu
//    does).  int8 and fp8 e4m3 codes widen to bf16 exactly, so the
//    quantized cache takes the same products; its per-cluster k-scale
//    multiplies the block's raw logits and its v-scale the block's sum,
//    once.
//  * Head tiles.  A block takes 64 heads, one wgmma M tile (G = 128: 2
//    tiles; G = 100: a second tile of 36 live heads; heads past G have
//    zero queries and are never written).
//  * Accumulator.  O is 64 x 576 f32 (147 KB): more than one warpgroup's
//    registers, so its columns are split between three consumer
//    warpgroups, 192 each (three 64-column swizzle atoms: wgmma reads an
//    MN-major B operand, V, from whole atoms only), 96 registers a thread:
//    384 threads, 168 registers each.  (Two warpgroups of 288 columns need
//    144 registers of O a thread; ptxas allocates the whole kernel at the
//    launch's 168 even under setmaxnreg, and spilled O around P.V on every
//    tile.  A producer warp beside three warpgroups leaves 152, and ptxas
//    then serialises the wgmma for want of registers; so thread 0 refills
//    the ring itself, at the end of each tile.)
//  * Shared memory.  q_hi and q_lo as the logits' A operand take 2 x 73.7
//    KB; a bf16 K or V tile of R rows takes R x 1152 B.  Of the choices
//    (32-row tiles with Q's columns split, the transposed product K.Q^T,
//    16-row tiles) the 16-row tile is the one that keeps a two-stage ring:
//    147.5 KB of Q + 2 x (18.4 + 18.4) KB of K/V + 4.6 KB of decrement
//    rows = 222.1 KB of the 227 KB a block may take.  The logits' k steps
//    are split between the warpgroups too (each takes the 192 columns of Q
//    and K that match its V, m64n16k16 twice a step), and each adds the
//    others' partial logits through shared memory, written into K atoms
//    that only their writer reads, once its products have read them (all
//    in the order (S_0 + S_1) + S_2, so all hold the same logits and the
//    same softmax state).
//  * Copies.  Thread 0 keeps the ring full with TMA (the K and V
//    tiles as nine 128-byte-swizzled atoms each; rows past the tensor load
//    as zeros; a strided K/V view is a tensor map of its strides).
//    Quantized codes come as contiguous rows through cp.async.bulk into a
//    two-stage ring of codes; each consumer warpgroup widens the K and V
//    columns it reads into one bf16 tile, so no warpgroup waits for
//    another.  V rows past a span are zeroed before P.V (p = 0 times a stale
//    NaN would not be 0).
//  * Softmax on the logits' fragment (16 rows of the tile across a quad of
//    lanes, two heads a thread), in natural units with the -1e30 sentinel
//    where the caller masks a row; rows past the span do not exist (p =
//    0).  block_gather's decrement (the selected centroid's stage-1 term,
//    a row of weight -1, f32 or bf16) is folded after the cluster's rows
//    on the CUDA cores, its logits from q_hi + q_lo (the query the
//    products see: its f32 dots with the row, no second read of q).
//  * Occupancy and merge.  One block an SM (222 KB).  The wrappers size
//    flash_decode's chunks so that one wave fills the 132 SMs (32 chunks
//    of 256 rows x 2 head tiles x B = 2 at S = 8192), and block_gather
//    takes one block a selected cluster and the extras in one chunk (32 +
//    1 parts x 2 x 2 = 132 blocks).  Each block writes its unnormalised
//    partial; with more than one part a (b, hkv, head tile), a second
//    launch merges them, one block a (b, head) row: a 64-head partial is
//    147 KB, so the last-ticket merge of latent_core.cuh would read 4.9
//    MB of partials through one SM at 33 parts, more time than the whole
//    kernel.
#pragma once

#include <cuda_fp16.h>
#include <string.h>

#include "hopper.cuh"
#include "latent_decode.cuh"

namespace lm {

constexpr int HEADS = 64;          // heads a block: one wgmma M tile
constexpr int R = 16;              // rows a K/V tile
constexpr int STAGES = 2;          // K/V tiles (or codes tiles) in flight
constexpr int WG = 128;            // threads a warpgroup
constexpr int WGS = 3;             // consumer warpgroups
constexpr int CONSUMERS = WGS * WG;
constexpr int THREADS = CONSUMERS;  // thread 0 also keeps the ring full
// Named barriers: the logits' exchange (written, read), the consumers,
// and each consumer warpgroup (BAR_WG + its index).
constexpr int BAR_X = 1, BAR_Y = 2, BAR_C = 3, BAR_WG = 4;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <int D>
struct Cfg {
  static constexpr int SWB = D % 64 == 0 ? 128 : 32;  // swizzle bytes
  static constexpr int W = SWB / 2;                    // columns an atom
  static constexpr int ATOMS = D / W;
  static constexpr int KPA = W / 16;                   // k16 steps an atom
  static constexpr int KSTEPS = D / 16;
  // Warpgroup w takes the logits' k steps [KW w, KW (w + 1)) and P.V's
  // columns [NW w, NW (w + 1)): a third of each, whole atoms.
  static constexpr int KW = KSTEPS / WGS;
  static constexpr int NW = D / WGS;
  static constexpr int AW = NW / W;                    // atoms a warpgroup
  static constexpr int Q_ATOM = HEADS * SWB;
  static constexpr int T_ATOM = R * SWB;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;       // q_hi or q_lo
  static constexpr int TILE = round_up(ATOMS * T_ATOM, 1024);  // K or V
  static constexpr int CODES = round_up(R * D, 128);   // K or V codes
  // The logits' exchange: a warpgroup's part (R / 2 floats a thread) goes
  // into the K tile's atoms that only it reads (at D = 576 its 3 atoms,
  // 6 KB), once its own products have read them; where they are too small
  // (D = 48), into a region of its own.
  static constexpr int X_BYTES = WG * (R / 2) * 4;
  static constexpr bool X_IN_K = AW * T_ATOM >= X_BYTES;
  static constexpr int X_STRIDE = X_IN_K ? AW * T_ATOM : X_BYTES;
  // Byte offsets from the 1024-aligned base: q_hi, q_lo, the ring of
  // STAGES (K, V) tiles (quantized: one bf16 (K, V) tile, then the ring
  // of codes), the exchange where it is not in K, the decrement rows (k
  // and v, f32) and logits, the barriers.
  static constexpr int OFF_QLO = Q_BYTES;
  static constexpr int OFF_T = 2 * Q_BYTES;
  static constexpr int OFF_CODES = OFF_T + 2 * TILE;
  static constexpr int OFF_X = OFF_T + STAGES * 2 * TILE;
  static constexpr int OFF_DEC = OFF_X + (X_IN_K ? 0 : WGS * X_BYTES);
  static constexpr int OFF_DL = OFF_DEC + 2 * D * 4;
  static constexpr int OFF_BAR = OFF_DL + HEADS * 4;
  static constexpr int SMEM = 1024 + OFF_BAR + 2 * STAGES * 8;
  static_assert(D % 16 == 0 && ATOMS * W == D, "whole atoms");
  static_assert(KW * WGS == KSTEPS && AW * W == NW && NW <= 256,
                "a third of the k steps and of the atoms a warpgroup");
  static_assert(OFF_CODES + STAGES * 2 * CODES <= OFF_X, "codes ring");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The byte of an atom of SWB-byte rows at which TMA's swizzle puts logical
// byte `off` (16-byte chunk bits 4.. XOR row bits 7..).
template <int SWB>
__device__ __forceinline__ int swz(int off) {
  return off ^ (((off >> 7) & (SWB / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// x = hi + lo with hi, lo bf16: hi = round(x), lo = round(x - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = bf2(x - hf.x, y - hf.y);
}

// Eight codes widened to eight bf16 (exactly).
template <typename TK>
__device__ __forceinline__ uint4 widen8(uint2 c);
template <>
__device__ __forceinline__ uint4 widen8<int8_t>(uint2 c) {
  const uint32_t w[2] = {c.x, c.y};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i / 2] >> (16 * (i % 2));
    o[i] = bf2((float)(int8_t)(u & 0xffu), (float)(int8_t)((u >> 8) & 0xffu));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ uint4 widen8<__nv_fp8_e4m3>(uint2 c) {
  const uint32_t w[2] = {c.x, c.y};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_fp8x2_storage_t u =
        (__nv_fp8x2_storage_t)((w[i / 2] >> (16 * (i % 2))) & 0xffffu);
    const float2 f = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(u, __NV_E4M3)));
    o[i] = bf2(f.x, f.y);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// What a block streams: n rows of one (row of the leading axis b, head h)
// from rows row0 on, through the bf16 tensor maps km / vm, or (kc != null)
// as contiguous rows of one-byte codes at kc / vc.
struct Span {
  const CUtensorMap* km;
  const CUtensorMap* vm;
  const uint8_t* kc;
  const uint8_t* vc;
  int row0, h, b, n;
};

// The logit of row r of the span from its raw dot: the cluster's k-scale
// (1 where there is none: exact), sm_scale, softcap, the row's bias
// (bias[r]); the sentinel for a padded cluster (valid false).
struct Logit {
  float ksc, sm_scale, cap;
  const float* bias;
  bool valid;
};

// After the span: the v-scale on the block's sum, and the decrement (a row
// of weight -1: its values vsel (f32 or bf16), its logits in shared
// memory, taken before the span from ksel).
struct Epi {
  float vsc;
  const void* ksel;
  const void* vsel;
  bool dec_f32;
  float dec_bias;
};

// Where a block writes: rows row0 + g of the outputs (g < G live), its
// part of nparts.
struct Out {
  float* o;
  float* m;
  float* l;
  float* o_part;
  float* m_part;
  float* l_part;
  size_t row0;
  int G, nparts, part;
};

// A consumer thread's state: its part of O (rows r and r + 8 of its
// warp's 16 heads, N columns) and the online softmax's m, l of the rows.
template <int N>
struct Acc {
  float a[N / 2];
  float m[2], l[2];
};

// mbar_wait that traps after ~10 s of waiting (2^34 cycles): a pipeline
// that can never fill becomes a launch failure, not a hung card.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (uint32_t tries = 1;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 1023) == 0 && clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ float dec_at(const void* p, bool f32, int i) {
  return f32 ? reinterpret_cast<const float*>(p)[i]
             : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

// Tile i of the span into its slot of the ring (the slot is free), by
// thread 0: TMA boxes of bf16 rows, or cp.async.bulk rows of codes.
template <int D>
__device__ __forceinline__ void issue_tile(const Span& sp, int i, uint8_t* t,
                                           uint64_t* full) {
  using C = Cfg<D>;
  const int slot = i % STAGES;
  if (sp.kc != nullptr) {
    const uint32_t bytes = (uint32_t)min(R, sp.n - i * R) * D;
    uint8_t* dst = t + C::OFF_CODES - C::OFF_T + slot * 2 * C::CODES;
    mbar_expect_tx(&full[slot], 2 * bytes);
    bulk_load(dst, sp.kc + (size_t)i * R * D, bytes, &full[slot]);
    bulk_load(dst + C::CODES, sp.vc + (size_t)i * R * D, bytes, &full[slot]);
  } else {
    uint8_t* dst = t + slot * 2 * C::TILE;
    mbar_expect_tx(&full[slot], 2 * C::ATOMS * C::T_ATOM);
    for (int a = 0; a < C::ATOMS; ++a) {
      tma_load_4d(dst + a * C::T_ATOM, sp.km, &full[slot], a * C::W,
                  sp.row0 + i * R, sp.h, sp.b);
      tma_load_4d(dst + C::TILE + a * C::T_ATOM, sp.vm, &full[slot],
                  a * C::W, sp.row0 + i * R, sp.h, sp.b);
    }
  }
}

// The 16-byte chunk of row r, columns c .. c + 7 of a bf16 tile of R-row
// atoms of SWB-byte rows.
template <int SWB>
__device__ __forceinline__ uint4* chunk_at(uint8_t* tile, int r, int c) {
  constexpr int W = SWB / 2;
  return reinterpret_cast<uint4*>(tile + (c / W) * (R * SWB) +
                                  swz<SWB>(r * SWB + (c % W) * 2));
}

// Columns [c0, c1) of `rows` rows of codes (rows D bytes apart) widened
// into the swizzled bf16 tile; rows past `rows` are zero.
template <int D, typename TK>
__device__ __forceinline__ void widen_cols(const uint8_t* src, uint8_t* dst,
                                           int c0, int c1, int rows,
                                           int t128) {
  const int groups = (c1 - c0) / 8;
  for (int i = t128; i < R * groups; i += WG) {
    const int r = i / groups, c = c0 + (i % groups) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      out = widen8<TK>(*reinterpret_cast<const uint2*>(src + r * D + c));
    *chunk_at<Cfg<D>::SWB>(dst, r, c) = out;
  }
}

// Rows [rows, R) of columns [c0, c1) of a swizzled bf16 tile set to zero.
template <int D>
__device__ __forceinline__ void zero_rows(uint8_t* dst, int c0, int c1,
                                          int rows, int t128) {
  const int groups = (c1 - c0) / 8;
  for (int i = t128; i < (R - rows) * groups; i += WG)
    *chunk_at<Cfg<D>::SWB>(dst, rows + i / groups, c0 + (i % groups) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

// Calls f(x, i, col) for each accumulator element x of the thread: row i
// (0: head r, 1: head r + 8 of its warp's 16) and column col (from the
// warpgroup's first, col0).
template <int N, typename F>
__device__ __forceinline__ void each(Acc<N>& acc, int col0, F&& f) {
  const int q = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    f(acc.a[i], (i >> 1) & 1, col0 + 8 * (i >> 2) + q + (i & 1));
}

// One consumer warpgroup (w) over the span: the logits' k steps [KW w,
// KW (w + 1)) and P.V's columns [NW w, NW (w + 1)).
template <int D, typename TK>
__device__ __forceinline__ void consume(const Span& sp, const Logit& logit,
                                        uint8_t* base, uint64_t* full,
                                        uint64_t* empty, Acc<Cfg<D>::NW>& acc) {
  using C = Cfg<D>;
  const int tid = threadIdx.x, w = tid / WG, t128 = tid % WG;
  const int lane = tid & 31;
  const int col0 = w * C::NW, k0 = w * C::KW;
  const uint64_t dq0 = make_desc<C::SWB>(base, 16, 8 * C::SWB);  // q_hi
  uint8_t* t = base + C::OFF_T;
  const bool codes = sp.kc != nullptr;
  const int nt = (sp.n + R - 1) / R;
#pragma unroll
  for (int i = 0; i < C::NW / 2; ++i) acc.a[i] = 0.f;
  acc.m[0] = acc.m[1] = NEG_INF_F;
  acc.l[0] = acc.l[1] = 0.f;
  for (int it = 0; it < nt; ++it) {
    const int slot = it % STAGES;
    const int rows = min(R, sp.n - it * R);
    wait(&full[slot], (it / STAGES) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    uint8_t* kt;
    uint8_t* vt;
    if (codes) {
      // Widen this warpgroup's K and V columns into the bf16 tile; the
      // codes' slot is free once every consumer has read it.
      if constexpr (sizeof(TK) == 1) {
        const uint8_t* ct = t + C::OFF_CODES - C::OFF_T + slot * 2 * C::CODES;
        widen_cols<D, TK>(ct, t, col0, col0 + C::NW, rows, t128);
        widen_cols<D, TK>(ct + C::CODES, t + C::TILE, col0, col0 + C::NW,
                          rows, t128);
      }
      fence_proxy_async();
      mbar_arrive(&empty[slot]);
      named_sync(BAR_WG + w, WG);
      kt = t;
      vt = t + C::TILE;
    } else {
      kt = t + slot * 2 * C::TILE;
      vt = kt + C::TILE;
      if (rows < R) {
        zero_rows<D>(vt, col0, col0 + C::NW, rows, t128);
        fence_proxy_async();
        named_sync(BAR_WG + w, WG);
      }
    }

    // This warpgroup's part of the logits: (q_hi + q_lo) . k over its k
    // steps, f32 sums of exact bf16 products.  Each step's descriptors are
    // a base plus the step's offset (in the 16-byte units of the address
    // field, which no offset here carries out of); the query's base passes
    // through an opaque move each tile, so that its step descriptors are
    // not hoisted out of the loop into registers that O needs.
    uint64_t dq;
    asm volatile("mov.b64 %0, %1;\n" : "=l"(dq) : "l"(dq0));
    const uint64_t dk = make_desc<C::SWB>(kt, 16, 8 * C::SWB);
    float s[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) s[i] = 0.f;
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < C::KW; ++j) {
      const int kk = k0 + j;
      const int a = kk / C::KPA, off = (kk % C::KPA) * 32;
      const uint64_t db = dk + ((a * C::T_ATOM + off) >> 4);
      const uint64_t da = dq + ((a * C::Q_ATOM + off) >> 4);
      wgmma_ss<R>(s, da, db, j > 0);
      wgmma_ss<R>(s, da + (C::OFF_QLO >> 4), db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // The warpgroups' parts, summed (S_0 + S_1) + S_2 in each (BAR_Y: every
    // part is read before a warpgroup writes over its K atoms again).
    uint8_t* xk = C::X_IN_K ? kt + col0 / C::W * C::T_ATOM
                            : base + C::OFF_X;
#pragma unroll
    for (int i = 0; i < R / 2; ++i)
      reinterpret_cast<float*>(xk + (C::X_IN_K ? 0 : w * C::X_STRIDE))
          [i * WG + t128] = s[i];
    named_sync(BAR_X, CONSUMERS);
    const uint8_t* x0 = C::X_IN_K ? kt : base + C::OFF_X;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      float p[WGS];
#pragma unroll
      for (int u = 0; u < WGS; ++u)
        p[u] = u == w ? s[i]
                      : reinterpret_cast<const float*>(
                            x0 + u * C::X_STRIDE)[i * WG + t128];
      s[i] = (p[0] + p[1]) + p[2];
    }
    named_sync(BAR_Y, CONSUMERS);

    // Softmax: element s[4j + e] is head row e / 2 and tile row 8j +
    // 2 (lane % 4) + e % 2.  The logits' steps are uniform branches around
    // all the thread's elements, not one per element.
#pragma unroll
    for (int e = 0; e < R / 2; ++e) s[e] = s[e] * logit.ksc * logit.sm_scale;
    if (logit.cap > 0.f) {
#pragma unroll
      for (int e = 0; e < R / 2; ++e)
        s[e] = logit.cap * tanhf(s[e] / logit.cap);
    }
    if (logit.bias != nullptr) {  // (rows past the span read the last)
#pragma unroll
      for (int e = 0; e < R / 2; ++e)
        s[e] += __ldg(logit.bias + min(sp.n - 1, it * R + 8 * (e >> 2) +
                                                     2 * (lane & 3) + (e & 1)));
    }
    float mx[2] = {acc.m[0], acc.m[1]};
#pragma unroll
    for (int e = 0; e < R / 2; ++e) {
      const int c = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      s[e] = c >= rows ? -INFINITY : logit.valid ? s[e] : NEG_INF_F;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(acc.m[i] - mx[i]);
      acc.m[i] = mx[i];
    }
    // P = exp(x - m) as the bf16 A fragments P_hi + P_lo of one k16 step:
    // a[2 j] row 0, a[2 j + 1] row 1 of s chunk j.
    uint32_t p_hi[4], p_lo[4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p00 = __expf(s[4 * j] - mx[0]);
      const float p01 = __expf(s[4 * j + 1] - mx[0]);
      const float p10 = __expf(s[4 * j + 2] - mx[1]);
      const float p11 = __expf(s[4 * j + 3] - mx[1]);
      rs[0] += p00 + p01;
      rs[1] += p10 + p11;
      split2(p00, p01, p_hi[2 * j], p_lo[2 * j]);
      split2(p10, p11, p_hi[2 * j + 1], p_lo[2 * j + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) acc.l[i] = acc.l[i] * alpha[i] + rs[i];
    each(acc, col0, [&](float& x, int i, int) { x *= alpha[i]; });

    // O += P_hi.V + P_lo.V over this warpgroup's atoms of V.
    wgmma_fence();
    fence_regs(acc.a);
    const uint64_t dv = make_desc<C::SWB>(vt + col0 / C::W * C::T_ATOM,
                                          C::T_ATOM, 8 * C::SWB);
    wgmma_rs<C::NW>(acc.a, p_hi, dv, 1);
    wgmma_rs<C::NW>(acc.a, p_lo, dv, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc.a);
    if (!codes) {
      fence_proxy_async();  // the exchange's writes before TMA's next ones
      mbar_arrive(&empty[slot]);
    }
    // Thread 0 refills the slot with tile it + STAGES once every consumer
    // is done with it.
    if (tid == 0 && it + STAGES < nt) {
      wait(&empty[slot], (it / STAGES) & 1);
      issue_tile<D>(sp, it + STAGES, t, full);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    acc.l[i] += __shfl_xor_sync(0xffffffffu, acc.l[i], 1);
    acc.l[i] += __shfl_xor_sync(0xffffffffu, acc.l[i], 2);
  }
}

// The warpgroup's epilogue: v-scale, decrement, and the write of its
// columns (normalised with one part, else the unnormalised partial), as
// float2 pairs into the thread's two rows.
template <bool SIGNED, int D>
__device__ __forceinline__ void finish(Acc<Cfg<D>::NW>& acc, const Epi& epi,
                                       const float* vrow, const float* dl,
                                       const Out& out, int g0) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % WG) / 32;
  const int col0 = threadIdx.x / WG * C::NW;
  const int hr[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  if (epi.vsc != 1.f)
    each(acc, col0, [&](float& x, int, int) { x *= epi.vsc; });
  if (epi.vsel != nullptr) {
    float e1[2], e2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float d = dl[hr[i]];
      const float m2 = fmaxf(acc.m[i], d);
      e1[i] = expf(acc.m[i] - m2);
      e2[i] = expf(d - m2);
      acc.l[i] = acc.l[i] * e1[i] - e2[i];
      acc.m[i] = m2;
    }
    each(acc, col0, [&](float& x, int i, int col) {
      x = x * e1[i] - vrow[col] * e2[i];
    });
  }
  // The thread's two rows: where they go (null past G), and what they
  // are divided by (dc::normalise's divisor with one part, else 1: the
  // unnormalised partial).
  const bool one = out.nparts == 1;
  float* dst[2];
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = g0 + hr[i];
    const size_t row = out.row0 + g;
    const float l = acc.l[i];
    dst[i] = g >= out.G ? nullptr
             : one      ? out.o + row * D
                        : out.o_part + (row * out.nparts + out.part) * D;
    den[i] = !one     ? 1.f
             : SIGNED ? (fabsf(l) > 1e-30f ? l : 1.f)
                      : fmaxf(l, 1e-30f);
  }
  const int q = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < C::NW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (dst[i] != nullptr)
        *reinterpret_cast<float2*>(dst[i] + q + 8 * j) =
            make_float2(acc.a[4 * j + 2 * i] / den[i],
                        acc.a[4 * j + 2 * i + 1] / den[i]);
  if (col0 == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = g0 + hr[i];
      if (g >= out.G) continue;
      const size_t row = out.row0 + g;
      if (one) {
        out.m[row] = acc.m[i];
        out.l[row] = acc.l[i];
      } else {
        out.m_part[row * out.nparts + out.part] = acc.m[i];
        out.l_part[row * out.nparts + out.part] = acc.l[i];
      }
    }
  }
}

// One block: heads g0 .. g0 + 63 of the f32 query rows q (G rows of D)
// over the span; the decrement's logits when epi.vsel is set (its valid
// flag and bias in `dec_valid` / epi.dec_bias).
template <bool SIGNED, int D, typename TK>
__device__ __forceinline__ void block(const Span& sp, const Logit& logit,
                                      const Epi& epi, bool dec_valid,
                                      const float* q, int g0, const Out& out) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* empty = full + STAGES;
  float* krow = reinterpret_cast<float*>(base + C::OFF_DEC);
  float* vrow = krow + D;
  float* dl = reinterpret_cast<float*>(base + C::OFF_DL);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  if (tid == 0) {  // the ring's first tiles, in flight during the split
    if (sp.kc == nullptr) {
      tma_prefetch_desc(sp.km);
      tma_prefetch_desc(sp.vm);
    }
    for (int i = 0; i < STAGES && i * R < sp.n; ++i)
      issue_tile<D>(sp, i, base + C::OFF_T, full);
  }
  const int G = out.G;

  // The decrement's rows, f32 in shared memory: loaded here, stored after
  // the query's split, so that both sets of loads are in flight together.
  constexpr int DSTEPS = (D + CONSUMERS - 1) / CONSUMERS;
  float kv[DSTEPS][2];
  const bool dec = epi.vsel != nullptr;
#pragma unroll
  for (int j = 0; j < DSTEPS; ++j) {
    const int c = tid + j * CONSUMERS;
    if (dec && c < D) {
      kv[j][0] = dec_at(epi.ksel, epi.dec_f32, c);
      kv[j][1] = dec_at(epi.vsel, epi.dec_f32, c);
    }
  }
  // q_hi, q_lo: 8 columns (one 16-byte chunk of each) a step; unrolled,
  // so that all the steps' loads are in flight together.
  constexpr int GR = D / 8;
  constexpr int QSTEPS = (HEADS * GR + CONSUMERS - 1) / CONSUMERS;
#pragma unroll
  for (int j = 0; j < QSTEPS; ++j) {
    const int i = tid + j * CONSUMERS;
    if (HEADS * GR % CONSUMERS != 0 && i >= HEADS * GR) break;
    const int h = i / GR, c = (i % GR) * 8;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (g0 + h < G) {
      const float4* p =
          reinterpret_cast<const float4*>(q + (size_t)(g0 + h) * D + c);
      x0 = __ldg(p);
      x1 = __ldg(p + 1);
    }
    uint4 hi, lo;
    split2(x0.x, x0.y, hi.x, lo.x);
    split2(x0.z, x0.w, hi.y, lo.y);
    split2(x1.x, x1.y, hi.z, lo.z);
    split2(x1.z, x1.w, hi.w, lo.w);
    const int off = (c / C::W) * C::Q_ATOM +
                    swz<C::SWB>(h * C::SWB + (c % C::W) * 2);
    *reinterpret_cast<uint4*>(base + off) = hi;
    *reinterpret_cast<uint4*>(base + C::OFF_QLO + off) = lo;
  }
#pragma unroll
  for (int j = 0; j < DSTEPS; ++j) {
    const int c = tid + j * CONSUMERS;
    if (dec && c < D) {
      krow[c] = kv[j][0];
      vrow[c] = kv[j][1];
    }
  }
  fence_proxy_async();
  named_sync(BAR_C, CONSUMERS);
  // The decrement row's logits: q_hi + q_lo (the query the products see,
  // exact in f32) from shared memory, a warp a head at a time, a lane
  // 16-byte chunks of 8 columns.
  if (dec) {
#pragma unroll 1
    for (int h = warp; h < HEADS; h += CONSUMERS / 32) {
      float d = 0.f;
      for (int c = 8 * lane; c < D; c += 8 * 32) {
        const int off = (c / C::W) * C::Q_ATOM +
                        swz<C::SWB>(h * C::SWB + (c % C::W) * 2);
        const uint4 hi = *reinterpret_cast<const uint4*>(base + off);
        const uint4 lo = *reinterpret_cast<const uint4*>(base + C::OFF_QLO +
                                                         off);
        const uint32_t hw[4] = {hi.x, hi.y, hi.z, hi.w};
        const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hw[j]));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&lw[j]));
          d = fmaf(a.x + b.x, krow[c + 2 * j], d);
          d = fmaf(a.y + b.y, krow[c + 2 * j + 1], d);
        }
      }
      d = warp_sum(d);
      if (lane == 0)
        dl[h] = dec_valid ? softcap_f(d * logit.sm_scale, logit.cap) +
                                epi.dec_bias
                          : NEG_INF_F;
    }
    named_sync(BAR_C, CONSUMERS);
  }

  Acc<C::NW> acc;
  consume<D, TK>(sp, logit, base, full, empty, acc);
  finish<SIGNED, D>(acc, epi, vrow, dl, out, g0);
}

struct DecodeArgs {
  const float* q;
  const float* bias;
  float* o;
  float* m;
  float* l;
  float* o_part;
  float* m_part;
  float* l_part;
  int Hkv, G, S, chunk;
  float sm_scale, cap;
};

// Grid (chunks of S, head tiles of 64, B * Hkv).
template <int D>
__global__ void __launch_bounds__(THREADS, 1) latent_flash_decode_wgmma(
    const __grid_constant__ CUtensorMap km,
    const __grid_constant__ CUtensorMap vm, const DecodeArgs a) {
  const int part = blockIdx.x, bh = blockIdx.z;
  const int g0 = blockIdx.y * HEADS;
  const int s0 = part * a.chunk, n = min(a.S, s0 + a.chunk) - s0;
  const Span sp{&km, &vm, nullptr, nullptr, s0, bh % a.Hkv, bh / a.Hkv, n};
  const Logit lg{1.f, a.sm_scale, a.cap,
                 a.bias == nullptr ? nullptr : a.bias + (size_t)bh * a.S + s0,
                 true};
  const Epi epi{1.f, nullptr, nullptr, false, 0.f};
  const Out out{a.o, a.m, a.l, a.o_part, a.m_part, a.l_part,
                (size_t)bh * a.G, a.G, (int)gridDim.x, part};
  block<false, D, __nv_bfloat16>(sp, lg, epi, false,
                                 a.q + (size_t)bh * a.G * D, g0, out);
}

// Grid (I clusters + extras chunks, head tiles of 64, B * Hkv).  TK: the
// cache's type (bf16, or int8 / fp8 codes with a.kv_k_scale /
// a.kv_v_scale); the extras are bf16.
template <typename TK, int D>
__global__ void __launch_bounds__(THREADS, 1) latent_gather_wgmma(
    const __grid_constant__ CUtensorMap km,
    const __grid_constant__ CUtensorMap vm,
    const __grid_constant__ CUtensorMap ekm,
    const __grid_constant__ CUtensorMap evm, const LatentGatherArgs a) {
  constexpr bool kScaled = Quant<TK>::enabled;
  const int part = blockIdx.x, bh = blockIdx.z;
  const int b = bh / a.Hkv, h = bh % a.Hkv, g0 = blockIdx.y * HEADS;
  const Out out{a.o, a.m, a.l, a.o_part, a.m_part, a.l_part,
                (size_t)bh * a.G, a.G, (int)gridDim.x, part};
  // A cluster part, or a chunk of the recent ring + self-KV (validity in
  // the bias).
  Span sp{&ekm, &evm, nullptr, nullptr, 0, h, b, 0};
  Logit lg{1.f, a.sm_scale, a.cap, nullptr, true};
  Epi epi{1.f, nullptr, nullptr, a.dec_f32, 0.f};
  if (part < a.I) {
    const int sel = a.selected[(size_t)bh * a.I + part];
    lg.valid = sel >= 0;
    const int cid = lg.valid ? sel : 0;  // -1 reads cluster 0 (masked)
    const size_t sc = (size_t)bh * (a.S / a.C) + cid;
    const int row = a.rows != nullptr ? a.rows[b] : b;
    sp = Span{&km, &vm, nullptr, nullptr, cid * a.C, h, row, a.C};
    if constexpr (kScaled) {
      const size_t off =
          (((size_t)row * a.Hkv + h) * a.S + (size_t)cid * a.C) * D;
      sp.kc = reinterpret_cast<const uint8_t*>(a.k) + off;
      sp.vc = reinterpret_cast<const uint8_t*>(a.v) + off;
      lg.ksc = a.kv_k_scale[sc];
      epi.vsc = a.kv_v_scale[sc];
    }
    if (a.k_sel != nullptr) {
      const size_t ci = (size_t)bh * a.I + part;
      const size_t de = a.dec_f32 ? 4 : 2;  // f32, or bf16 beside bf16 rows
      epi.ksel = reinterpret_cast<const uint8_t*>(a.k_sel) + ci * D * de;
      epi.vsel = reinterpret_cast<const uint8_t*>(a.v_sel) + ci * D * de;
      epi.dec_bias = a.sel_bias[ci];
    }
  } else {
    const int x0 = (part - a.I) * a.xrows;
    sp.row0 = x0;
    sp.n = min(a.E - x0, a.xrows);
    lg.bias = a.eb + (size_t)b * a.E + x0;
  }
  block<true, D, TK>(sp, lg, epi, lg.valid, a.q + (size_t)bh * a.G * D, g0,
                     out);
}

// The merge of rows' nparts partials (o_part (rows, nparts, D), m_part /
// l_part (rows, nparts)): one block a row.
int merge_launch(bool signed_l, const float* o_part, const float* m_part,
                 const float* l_part, float* o, float* m, float* l, int rows,
                 int nparts, int D, cudaStream_t stream);

// A bf16 (B, Hkv, S, D) tensor map of rows D apart, heads sh and batches
// sb elements apart, boxes of one atom x R rows.
template <int D>
bool rows_map(CUtensorMap* map, const void* p, int B, int Hkv, int S,
              long long sb, long long sh) {
  using C = Cfg<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hkv,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::W, (cuuint32_t)R, 1, 1};
  return encode_map(map, p, 4, dims, strides, box, Swizzle<C::SWB>::tma);
}

// Stage 2 on the tensor cores: the cache k / v (Bk rows of its leading
// axis) of TK, bf16 extras; grid as latent_gather_launch's with the
// extras in chunks of a.xrows rows.
template <typename TK>
int gather_launch(const LatentGatherArgs& a, int B, int Bk, int D,
                  cudaStream_t stream) {
  const int nx = a.ek != nullptr ? (a.E + a.xrows - 1) / a.xrows : 0;
  const int nparts = a.I + nx;
  const dim3 grid(nparts, (a.G + HEADS - 1) / HEADS, B * a.Hkv);
  DISPATCH_LATENT_DIM(D, {
    using C = Cfg<kD>;
    CUtensorMap km, vm, ekm, evm;
    memset(&km, 0, sizeof(km));
    memset(&vm, 0, sizeof(vm));
    memset(&ekm, 0, sizeof(ekm));
    memset(&evm, 0, sizeof(evm));
    const long long sh = (long long)a.S * kD;
    if (!Quant<TK>::enabled &&
        (!rows_map<kD>(&km, a.k, Bk, a.Hkv, a.S, sh * a.Hkv, sh) ||
         !rows_map<kD>(&vm, a.v, Bk, a.Hkv, a.S, sh * a.Hkv, sh)))
      return (int)cudaErrorInvalidValue;
    const long long xh = (long long)a.E * kD;
    if (nx > 0 && (!rows_map<kD>(&ekm, a.ek, B, a.Hkv, a.E, xh * a.Hkv, xh) ||
                   !rows_map<kD>(&evm, a.ev, B, a.Hkv, a.E, xh * a.Hkv, xh)))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(latent_gather_wgmma<TK, kD>, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    latent_gather_wgmma<TK, kD><<<grid, THREADS, C::SMEM, stream>>>(
        km, vm, ekm, evm, a);
    err = cudaGetLastError();
    if (err != cudaSuccess || nparts == 1) return (int)err;
    return merge_launch(true, a.o_part, a.m_part, a.l_part, a.o, a.m, a.l,
                        B * a.Hkv * a.G, nparts, kD, stream);
  })
}

// flash_decode on the tensor cores: bf16 k / v (strides as
// flash_decode_latent_launch's), chunks of `chunk` rows.
int decode_launch(const DecodeArgs& a, const void* k, const void* v, int B,
                  int D, long long kv_sb, long long kv_sh,
                  cudaStream_t stream);

}  // namespace lm
