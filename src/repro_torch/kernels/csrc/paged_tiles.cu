// Decode, verify and chunked-prefill attention on Hopper's tensor cores
// (sm_90a), over a paged pool (float or int8 pages) or a contiguous cache
// (float or int8 lines): every attention kernel of the port.
//
// Replaces the Pallas TPU kernels
//   B1 src/repro/kernels/paged_decode.py  paged_verify / paged_decode
//   B2 src/repro/kernels/paged_prefill.py paged_prefill
//   B4 src/repro/kernels/paged_decode.py  paged_verify_quant /
//                                          paged_decode_quant
//   B5 src/repro/kernels/flash_decode.py  flash_verify / flash_decode
// (B5 over an int8 cache fuses the model's dequantize-then-attend.)
//
// What each computes: GQA flash attention of R = T*n_rep query rows of one
// (sequence b, kv head h). Row r = t*n_rep + rep reads query head
// h*n_rep + rep, sits at absolute position kv_len[b] - T + t and sees
// positions <= its own (and > own - window when a window is set). Paged:
// key j of sequence b is slot j % bs of page table[b, j / bs]; contiguous:
// key j is line j of the cache, base + b*sb + j*ss + h*sh through the
// caller's strides, and only the first S lines exist (kv_len may exceed S).
// Online softmax (m, l, acc) in f32; a fully masked row returns 0 (l
// floored at 1e-30).
//
// What bounds it on the H100:
//   * B2, and B4 on a prompt chunk (S = 256 rows x 5 heads of a group
//     against up to 2048 keys): operations. Each K/V byte feeds up to 1280
//     rows, above the card's ~295 flop/byte ridge; the work is ~4.7 GFLOP
//     at S = 256, kv_len 1024 (about 5 us of bf16 tensor-core time).
//   * B1, B4 and B5 at decode and verify (T*n_rep <= 64 rows): bytes. Each
//     K/V byte is read once and used by a handful of rows.
//
// What this design does about it:
//   * Design 1, the chunk-row tile (every B2 call, B1 and B4 when
//     T*n_rep > 64): one CTA per (128-row tile, kv head, sequence), 8 warps
//     of 16 rows. The rows pack the n_rep query heads of a group, so each
//     K/V block is staged once for all of them. The tile walks its live
//     keys in blocks of 64 (32 for f32 pages): cp.async 16-byte copies,
//     routed per key through the table (one page id a thread a block,
//     looked up a block ahead), into a ring of 2 (float pages) or 3 (int8)
//     stages, so the next blocks' gather overlaps this block's products.
//     S = Q.K^T and O += P.V run on mma.sync m16n8k16 (bf16 operands, f32
//     sums) fed by ldmatrix from rows padded by 16 bytes (no bank
//     conflicts). Masks are applied only on blocks that cross a row's
//     causal or window frontier; keys past the tile's frontier or wholly
//     behind its window are never loaded. Softmax runs in base 2 for bf16
//     results (the scale folds in log2 e).
//   * Design 2, split keys (B1, B4 at T*n_rep <= 64; every B5 call): the
//     same tile code with 4 warps and the key walk cut into splits of 256
//     keys, one CTA per (row tile, split, kv head, sequence), so a decode
//     step runs B * h_kv * n_split CTAs instead of B * h_kv. The KS warps
//     of a row tile share it, each taking a fixed part of every key block
//     (KS = 4 warps on a 16-row tile, 2 on each of two 16-row tiles for
//     f32 pools; int8 pages at D_pad <= 128 keep the plan of the rows, KS
//     4, 2 or 1 at <= 16, <= 32, <= 64 rows), and merge in shared memory
//     in warp order. Each CTA writes
//     (acc, m, l) to scratch; a second kernel merges the splits in split
//     order (the merge_attention_stats rule), so the result does not
//     depend on scheduling. n_split comes from the table's width (the
//     cache's S) on the host, never from kv_len.
//   * A verify row equals a decode step to the bit (float pools, caches,
//     and int8 pages up to 16 rows or at D_pad 256). The split boundaries,
//     the key split and the rows a tile holds are fixed by the pool alone,
//     the walk starts at a block boundary counted from the split's start
//     (never at the tile's oldest row), the m16n8k16 product computes each
//     row on its own, and a block a row cannot see leaves its (m, l, acc)
//     exactly as they were. So row t of a T = 5 call sums what a T = 1 call
//     at its position sums, in the same order.
//   * Head dims: any D = 0 (mod 16) up to 256 runs on a tile built for
//     D_pad = 64, 128 or 256. q, K and V rows are staged D_pad wide with
//     columns D..D_pad zero-filled (every 16-byte chunk of a row is whole:
//     int8 rows are D bytes, bf16 2D, f32 4D). The zero columns add exact
//     zeros to Q.K^T and fill output columns that are never stored.
//   * Dynamic shared memory a CTA takes (Layout::BYTES, bytes; the CTA
//     adds 1024 of static m, l, and the limit is 232448), by q dtype, pool
//     dtype and D_pad:
//                        design 1                design 2
//       q    pool     64      128     256      64      128     256
//       f32  f32   115712  222208  217600   74240  143872  217600
//       f32  bf16   92160  174080  168960   43776   82688  160512
//       f32  int8   99840  189952  185088   60160  115456  226048
//       bf16 f32    78848  152576  150016   65024  126464  183808
//       bf16 bf16   55296  104448  101376   39168   73984  143616
//       bf16 int8   62976  120320  117504   55552  106752  209152
//     (design 2 at the fixed key split; int8 pages at key split 2 and 1:
//     f32 q 67072 / 80896 at D_pad 64, 128512 / 154624 at 128; bf16 q
//     57856 / 62464 and 111104 / 119808.) D_pad 256 takes a smaller layout: design 1 runs 4 warps (64-row
//     tiles) on blocks of half the keys, and design 2 over f32 pages keeps
//     one ring stage.
//   * Precision. A bf16 product of the f32 P loses the outputs near zero,
//     so P enters as bf16 pieces that sum to it: hi + lo for a bf16 result
//     (then rounded once to bf16), hi + mid + lo for an f32 one. f32 q and
//     f32 pages are split the same way into three pieces, and the products
//     of pieces whose orders sum below three are kept (6 of 9). For f32
//     results the tensor cores' truncating sums are kept short (each
//     16-wide step of Q.K^T and each block's P.V start from zero and are
//     added in f32) and the softmax is in base e; bf16 results take base 2
//     (one MUFU op an exponent). int8 K and V are exact in bf16; k_scale
//     multiplies the f32 score after the product and v_scale is folded
//     into P before it is split. The softmax scale multiplies the f32
//     score, never q.
//   * The pools and caches are read in their stored layout through their
//     strides and q in place as (B, T, H, D); int8 lines cross HBM as int8
//     (converted in shared memory), scales as their stored dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

// The file compiles as nine parts, all at once: the kernels of each (q
// dtype, pool dtype, scale dtype) pair in a part of their own
// (-DPAGED_TILES_PAIR=i, i in 0..7, the order of ``Pair`` below), and the
// C interface with the dispatch to the pairs (no PAGED_TILES_PAIR). The
// parts share the launch arguments' types and each pair's entry point.
namespace tile_parts {

struct Geo {
  int T, H, h_kv, D, bs, nb, window;     // window <= 0: none; D <= D_pad
  int rows, n_rep;                       // rows = T * n_rep
  int n_split, split_pages;              // key walk cut into n_split CTAs
  float scale;                           // 1/sqrt(D), rounded on the host
  long long q_sb, q_st, q_sh;            // q strides (elements); d contiguous
  // pool strides (page, slot, head) or cache strides (sequence, line,
  // head); d contiguous. The scales' likewise (int8 only).
  long long kv_sp, kv_ss, kv_sh;
  long long sc_sp, sc_ss, sc_sh;
};

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *kv_len;
  void *out, *part_acc, *part_ml, *lse;
};

// pair I's kernels launched through by_dim (defined in part I)
template <int I>
int pair_entry(const Args& a, const Geo& g, int B, int key_split,
               bool partial, bool contig, cudaStream_t s);

}  // namespace tile_parts

namespace {

using tile_parts::Args;
using tile_parts::Geo;

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// design 2's key split where the caller does not choose it: the pool alone
// fixes it (f32 blocks of 32 keys feed 2 warps; the others' 64 keys, 4)
template <typename KT>
constexpr int kFixedSplit = sizeof(KT) == 4 ? 2 : 4;

template <typename QT, typename KT, int D, int KS, bool kPartial>
struct Layout {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr bool kDirect = sizeof(KT) == 2;   // bf16: mma reads the ring
  static constexpr bool kWide = D > 128;             // D_pad 256
  // keys a block: 64 (32 for f32 pools), halved for design 1 at D_pad 256
  static constexpr int N =
      (sizeof(KT) == 4 ? 32 : 64) / (kWide && !kPartial ? 2 : 1);
  // ring stages: int8 blocks are small, so more of them are in flight (a
  // design-2 split of 256 keys is 4 blocks: all of it at once); float
  // pages keep 2, so that two bf16 CTAs (104 KB each) fit an SM; design 2
  // over f32 pages at D_pad 256 keeps 1
  static constexpr int STAGES =
      kQuant ? (kPartial ? 4 : 3)
             : (kWide && kPartial && sizeof(KT) == 4 ? 1 : 2);
  // design 1: 8 warps of 16 rows (4 at D_pad 256); design 2: 4 warps, KS
  // of them a row tile
  static constexpr int WARPS = kPartial || kWide ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int TR = 16 * WARPS / KS;         // rows a CTA
  static constexpr int LD = D + 8;                   // padded bf16 row
  static constexpr int NQ = Pieces<QT>::n;
  static constexpr int NKV = Pieces<KT>::n;
  static constexpr int NP = sizeof(QT) == 4 ? 3 : 2;  // pieces of P
  static constexpr int NT = N / 8 / KS;              // 8-key tiles a warp
  static constexpr int RING_ROW = kDirect ? LD * 2 : D * int(sizeof(KT));
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t RING_OFF = Q_OFF + size_t(NQ) * TR * LD * 2;
  static constexpr size_t PLANE_OFF =
      RING_OFF + size_t(STAGES) * 2 * N * RING_ROW;
  static constexpr size_t SCALE_OFF =
      PLANE_OFF + (kDirect ? 0 : size_t(2) * NKV * N * LD * 2);
  static constexpr size_t END =
      SCALE_OFF + (kQuant ? size_t(STAGES) * 2 * N * 4 : 0);
  static constexpr size_t RED = KS > 1 ? size_t(WARPS) * 16 * D * 4 : 0;
  static constexpr size_t BYTES = END > RED ? END : RED;
  static_assert(NT % 2 == 0, "warps take key tiles in pairs");
  static_assert(THREADS % N == 0 && THREADS / N >= 2 &&
                    (D * sizeof(KT) / 16) % (THREADS / N) == 0,
                "whole chunks a thread, a k and a v scale a key row");
};

constexpr size_t kStaticSmem = 2 * kMaxWarps * 16 * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
}
// int8 -> f32 without the quarter-rate I2F: byte b + 128 becomes the low
// mantissa byte of 2^23 (bits 0x4B0000uu), and 2^23 + 128 is subtracted
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[4 * h + i] =
          __uint_as_float(__byte_perm(w[h], 0x4B000000u, 0x7540u | i)) -
          8388736.f;
}

// exp in base e (f32 results: expf, to the ulp) or base 2 (bf16 results:
// one MUFU op; the scores then carry the factor log2 e)
template <bool kBaseE>
__device__ __forceinline__ float ex(float x) {
  if constexpr (kBaseE) return expf(x);
  else return exp2f(x);
}

// One CTA: a tile of TR rows of one (b, kv head) against the keys of one
// split (design 1: one split covering the table). kContig: the keys are a
// contiguous cache's lines (bs = 1, nb = S, no table). Fragment layout of
// m16n8k16: lane = 4 * g + tq holds rows g and g + 8, columns 2tq, 2tq + 1.
template <typename QT, typename KT, typename ST, int D, int KS, bool kPartial,
          bool kContig>
__global__ void __launch_bounds__(Layout<QT, KT, D, KS, kPartial>::THREADS)
paged_tile_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                  const KT* __restrict__ vp, const ST* __restrict__ ksc,
                  const ST* __restrict__ vsc, const int* __restrict__ table,
                  const int* __restrict__ kv_len, QT* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  Geo g) {
  using L = Layout<QT, KT, D, KS, kPartial>;
  constexpr int N = L::N, LD = L::LD, NT = L::NT, TR = L::TR, S = L::STAGES;
  constexpr int NQ = L::NQ, NKV = L::NKV, NP = L::NP;
  constexpr int NS = NQ > NKV ? NQ : NKV;    // keep piece pairs i + j < NS
  constexpr int NO = NP > NKV ? NP : NKV;
  constexpr int PRE = S > 1 ? S - 1 : 1;     // blocks in flight ahead
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = L::THREADS;
  __shared__ float m_sh[kMaxWarps][16], l_sh[kMaxWarps][16];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  unsigned char* ring = smem + L::RING_OFF;
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem + L::PLANE_OFF);
  float* scs = reinterpret_cast<float*>(smem + L::SCALE_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % g.n_split, tile = blockIdx.x / g.n_split;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_rep = g.n_rep, Dl = g.D;
  const int r0 = tile * TR;
  const int tile_rows = min(TR, g.rows - r0);
  const int len = kv_len[b];

  // live keys of this CTA, [k_lo, k_hi): whole pages, nothing past the
  // newest row's page (a contiguous cache: nothing past it or past S), no
  // page wholly behind the oldest row's window, only this split's keys.
  // The walk starts at kw, a block boundary counted from the split's
  // start; keys in [kw, k_lo) are zero-filled and masked.
  const int qpos_lo = len - g.T + r0 / n_rep;
  const int qpos_hi = len - g.T + (r0 + tile_rows - 1) / n_rep;
  const int split_keys = g.split_pages * g.bs, s0 = split * split_keys;
  int k_hi = qpos_hi < 0 ? 0 : min(g.nb, qpos_hi / g.bs + 1) * g.bs;
  int k_lo = g.window > 0 ? max(0, qpos_lo - g.window + 1) / g.bs * g.bs : 0;
  k_lo = max(k_lo, s0);
  k_hi = min(k_hi, s0 + split_keys);
  const int kw = s0 + (k_lo - s0) / N * N;
  const int n_blocks = k_hi > k_lo ? (k_hi - kw + N - 1) / N : 0;
  const long long n_part = (long long)gridDim.z * g.h_kv * g.n_split * g.rows;
  if (n_blocks == 0) {
    // no live key (a split past kv_len, a sink slot's later splits): an
    // empty split (m = -inf, l = 0; the combine skips it), or zero rows
    for (int i = tid; i < tile_rows * (kPartial ? 1 : Dl); i += kThreads) {
      if constexpr (kPartial) {
        const long long at =
            (((long long)b * g.h_kv + h) * g.n_split + split) * g.rows + r0 + i;
        part_ml[at] = -INFINITY;
        part_ml[n_part + at] = 0.f;
      } else {
        const int grow = r0 + i / Dl, t = grow / n_rep;
        const int head = h * n_rep + (grow - t * n_rep);
        store_as(out + (((long long)b * g.T + t) * g.H + head) * Dl + i % Dl,
                 0.f);
      }
    }
    return;
  }

  auto ring_k = [&](int st) { return ring + size_t(st) * 2 * N * L::RING_ROW; };
  auto ring_v = [&](int st) { return ring_k(st) + size_t(N) * L::RING_ROW; };

  // TPK threads copy one key row, CPT 16-byte chunks each, so a thread
  // looks up one page id a block, one block ahead of its copy; chunks at
  // or past the row's width (Dl) are zero-filled
  constexpr int CPR = D * int(sizeof(KT)) / 16;
  constexpr int TPK = kThreads / N;
  constexpr int CPT = CPR / TPK;
  const int cpr_live = Dl * int(sizeof(KT)) / 16;
  const int ik = tid / TPK, c0 = (tid % TPK) * CPT;
  // the page of this thread's key of block j (a contiguous cache: 0), or
  // -1 outside [k_lo, k_hi)
  auto page_of = [&](int j) -> long long {
    const int pos = kw + j * N + ik;
    if (j >= n_blocks || pos < k_lo || pos >= k_hi) return -1;
    if constexpr (kContig) return 0;
    else return table[(long long)b * g.nb + pos / g.bs];
  };
  auto line_of = [&](int j, long long pid, long long sp, long long ss,
                     long long sh) -> long long {
    const int pos = kw + j * N + ik;
    if constexpr (kContig)
      return (long long)b * sp + (long long)pos * ss + (long long)h * sh;
    else
      return pid * sp + (long long)(pos % g.bs) * ss + (long long)h * sh;
  };
  // block j's K and V rows into ring stage st (keys outside [k_lo, k_hi)
  // are zero-filled and never read from HBM); returns this thread's scale
  // of the block (int8: a row's first thread k_scale, its second v_scale)
  auto fetch = [&](int j, int st, long long pid) -> float {
    const bool live = pid >= 0;
    const long long off =
        live ? line_of(j, pid, g.kv_sp, g.kv_ss, g.kv_sh) : 0;
    unsigned char* dk = ring_k(st) + ik * L::RING_ROW;
    unsigned char* dv = ring_v(st) + ik * L::RING_ROW;
#pragma unroll
    for (int c = c0; c < c0 + CPT; ++c) {
      const bool cl = live && c < cpr_live;
      const long long e = cl ? off + c * (16 / int(sizeof(KT))) : 0;
      cp_async16(dk + c * 16, kp + e, cl);
      cp_async16(dv + c * 16, vp + e, cl);
    }
    if constexpr (L::kQuant) {    // threads 0 and 1 of a row: its k, v scale
      if (live && tid % TPK < 2) {
        const long long at = line_of(j, pid, g.sc_sp, g.sc_ss, g.sc_sh);
        return to_f32(tid % TPK == 0 ? ksc[at] : vsc[at]);
      }
    }
    return 0.f;
  };
  // stage st's scales: k at [0, N), v at [N, 2N)
  auto store_scale = [&](int st, float v) {
    if constexpr (L::kQuant)
      if (tid % TPK < 2) scs[st * 2 * N + (tid % TPK) * N + ik] = v;
  };
  static_assert(!L::kQuant || S > 1, "int8 scales are stored a block ahead");

  // prologue: blocks 0 .. S - 2 in flight (page ids first, all at once)
  long long pids[PRE];
  float scv[PRE];
#pragma unroll
  for (int j = 0; j < S - 1; ++j) pids[j] = page_of(j);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    scv[j] = j < n_blocks ? fetch(j, j, pids[j]) : 0.f;
    cp_async_commit();
  }
  long long pid_next = page_of(S - 1);

  // the tile's q rows as NQ bf16 planes; rows past the tile and columns
  // past Dl are zero
  for (int c = tid; c < TR * (D / 8); c += kThreads) {
    const int r = c / (D / 8), d0 = (c - r * (D / 8)) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < tile_rows && d0 < Dl) {
      const int row = r0 + r, t = row / n_rep;
      const int head = h * n_rep + (row - t * n_rep);
      load8(q + b * g.q_sb + t * g.q_st + head * g.q_sh + d0, x);
    }
    store8<NQ>(qs + r * LD + d0, TR * LD, x);
  }
#pragma unroll
  for (int j = 0; j < S - 1; ++j) store_scale(j, scv[j]);

  const int mt = warp / KS, kg = warp % KS;      // row tile, key part
  const int wrow0 = mt * 16;
  const bool wlive = wrow0 < tile_rows;
  const int gq = lane >> 2, tq = lane & 3;
  int qpos_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qpos_r[r] = len - g.T + (r0 + wrow0 + gq + 8 * r) / n_rep;
  const int wq_lo = len - g.T + (r0 + wrow0) / n_rep;
  const int wq_hi = len - g.T + (r0 + min(wrow0 + 15, tile_rows - 1)) / n_rep;
  const int kofs = kg * NT * 8;                  // this warp's keys of a block

  // f32 results: natural-base softmax, and each 16-wide step's products
  // (and each block's P.V) summed from zero, then added in f32: the tensor
  // cores truncate their sums, and a long chain of them drifts. bf16
  // results: scores, m and the partials' m in log2 units, p = 2^(x - m).
  constexpr bool kF32 = sizeof(QT) == 4;
  const float score_scale =
      kF32 ? g.scale : g.scale * 1.4426950408889634f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int j = 0; j < n_blocks; ++j) {
    const int st = j % S;
    const int jn = j + S - 1, sn = jn % S;
    __syncthreads();            // block j - 1 consumed: its stage sn is free
    const float sc_next = jn < n_blocks ? fetch(jn, sn, pid_next) : 0.f;
    cp_async_commit();
    pid_next = page_of(jn + 1);
    cp_async_wait<S - 1>();     // block j landed (this thread's copies) ...
    __syncthreads();            // ... and every thread's
    const __nv_bfloat16* kpl;
    const __nv_bfloat16* vpl;
    if constexpr (L::kDirect) {
      kpl = reinterpret_cast<const __nv_bfloat16*>(ring_k(st));
      vpl = reinterpret_cast<const __nv_bfloat16*>(ring_v(st));
    } else {
      // int8 (exact) or f32 (three pieces) rows -> bf16 planes
      const KT* rk = reinterpret_cast<const KT*>(ring_k(st));
      const KT* rv = reinterpret_cast<const KT*>(ring_v(st));
      for (int c = tid; c < N * (D / 8); c += kThreads) {
        const int i = c / (D / 8), d0 = (c - i * (D / 8)) * 8;
        float x[8];
        load8(rk + i * D + d0, x);
        store8<NKV>(planes + i * LD + d0, N * LD, x);
        load8(rv + i * D + d0, x);
        store8<NKV>(planes + (NKV * N + i) * LD + d0, N * LD, x);
      }
      __syncthreads();
      kpl = planes;
      vpl = planes + NKV * N * LD;
    }
    const float* ksc_s = scs + st * 2 * N;
    const float* vsc_s = ksc_s + N;

    if (wlive) {
      const int kb = kw + j * N;
      // S = Q . K^T over this warp's NT key tiles (a padded head's zero
      // columns add exact zeros)
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[NQ][4];
#pragma unroll
        for (int i = 0; i < NQ; ++i)
          ldsm_x4(qa[i], qs + i * TR * LD + (wrow0 + (lane & 15)) * LD +
                             kk * 16 + (lane >> 4) * 8);
        // all of this step's K fragments first, then the products, the
        // piece pairs outermost: no product waits on the one before it
        uint32_t kf[NT / 2][NKV][4];
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int key = kofs + np * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
          for (int jj = 0; jj < NKV; ++jj)
            ldsm_x4(kf[np][jj], kpl + (jj * N + key) * LD + col);
        }
        auto products = [&](float (&c)[NT][4]) {
#pragma unroll
          for (int jj = 0; jj < NKV; ++jj)
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              if (i + jj >= NS) continue;
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                mma(c[2 * np], qa[i], kf[np][jj][0], kf[np][jj][1]);
                mma(c[2 * np + 1], qa[i], kf[np][jj][2], kf[np][jj][3]);
              }
            }
        };
        if constexpr (kF32) {
          float t[NT][4] = {};
          products(t);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += t[n][e];
        } else {
          products(s);
        }
      }
      // scale, mask (only where the block crosses a row's frontier or the
      // live range), and the online softmax update
      const bool edge = kb < k_lo || kb + N > k_hi || kb + N - 1 > wq_lo ||
                        (g.window > 0 && kb <= wq_hi - g.window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kofs + n * 8 + 2 * tq + (e & 1);
          float x = s[n][e];
          if constexpr (L::kQuant) x *= ksc_s[key];
          x *= score_scale;
          if (edge) {
            const int pos = kb + key, qp = qpos_r[e >> 1];
            if (!(pos >= k_lo && pos < k_hi && pos <= qp &&
                  (g.window <= 0 || pos > qp - g.window)))
              x = -INFINITY;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], msafe[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        msafe[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = m_r[r] == -INFINITY ? 0.f : ex<kF32>(m_r[r] - msafe[r]);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex<kF32>(s[n][e] - msafe[e >> 1]);   // 0 where masked
          s[n][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rs[r];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= corr[0];
        acc[dn][1] *= corr[0];
        acc[dn][2] *= corr[1];
        acc[dn][3] *= corr[1];
      }
      // O += P . V, 16 keys a step; P (v_scale folded in) as NP pieces
      auto pv_products = [&](float (&c)[D / 8][4]) {
#pragma unroll
        for (int k2 = 0; k2 < NT / 2; ++k2) {
          float pv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = 2 * k2 + (e >> 2);
            pv[e] = s[n][e & 3];
            if constexpr (L::kQuant)
              pv[e] *= vsc_s[kofs + n * 8 + 2 * tq + (e & 1)];
          }
          // A fragment: (row g, keys 2tq), (row g + 8, keys 2tq),
          // (row g, keys 8 + 2tq), (row g + 8, keys 8 + 2tq)
          uint32_t pp[4][NP], pa[NP][4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
            pieces2<NP>(pv[2 * f], pv[2 * f + 1], pp[f]);
#pragma unroll
          for (int i = 0; i < NP; ++i)
#pragma unroll
            for (int f = 0; f < 4; ++f) pa[i][f] = pp[f][i];
          const int key = kofs + k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          // V fragments of DG 16-column groups at a time, then the products
          constexpr int DG = NKV == 1 ? D / 16 : 2;
#pragma unroll
          for (int d0 = 0; d0 < D / 16; d0 += DG) {
            uint32_t vf[DG][NKV][4];
#pragma unroll
            for (int dn = 0; dn < DG; ++dn)
#pragma unroll
              for (int jj = 0; jj < NKV; ++jj)
                ldsm_x4_trans(vf[dn][jj], vpl + (jj * N + key) * LD +
                                              (d0 + dn) * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int jj = 0; jj < NKV; ++jj)
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                if (i + jj >= NO) continue;
#pragma unroll
                for (int dn = 0; dn < DG; ++dn) {
                  mma(c[2 * (d0 + dn)], pa[i], vf[dn][jj][0], vf[dn][jj][1]);
                  mma(c[2 * (d0 + dn) + 1], pa[i], vf[dn][jj][2],
                      vf[dn][jj][3]);
                }
              }
          }
        }
      };
      if constexpr (kF32) {
        float o[D / 8][4] = {};
        pv_products(o);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dn][e] += o[dn][e];
      } else {
        pv_products(acc);
      }
    }
    if (jn < n_blocks) store_scale(sn, sc_next);   // read at iteration jn
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
  }
  if constexpr (KS > 1) {
    // the KS warps of a row tile merge their (m, l, acc), in warp order
    cp_async_wait<0>();
    __syncthreads();            // the ring is free: it holds the partial accs
    float* red = reinterpret_cast<float*>(smem);
    if (tq == 0) {
      m_sh[warp][gq] = m_r[0];
      m_sh[warp][gq + 8] = m_r[1];
      l_sh[warp][gq] = l_r[0];
      l_sh[warp][gq + 8] = l_r[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gq + 8 * r;
      float M = -INFINITY;
      for (int k = 0; k < KS; ++k) M = fmaxf(M, m_sh[mt * KS + k][row]);
      const float Ms = M == -INFINITY ? 0.f : M;
      float Lsum = 0.f;
      for (int k = 0; k < KS; ++k) {
        const float mk = m_sh[mt * KS + k][row];
        if (mk != -INFINITY) Lsum += l_sh[mt * KS + k][row] * ex<kF32>(mk - Ms);
      }
      const float f = m_r[r] == -INFINITY ? 0.f : ex<kF32>(m_r[r] - Ms);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * r] *= f;
        acc[dn][2 * r + 1] *= f;
      }
      m_r[r] = M;
      l_r[r] = Lsum;
    }
    if (kg != 0 && wlive) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store2(red + (warp * 16 + gq + 8 * r) * D + dn * 8 + 2 * tq,
                 acc[dn][2 * r], acc[dn][2 * r + 1]);
    }
    __syncthreads();
    if (kg == 0 && wlive) {
      for (int k = 1; k < KS; ++k) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 o = *reinterpret_cast<const float2*>(
                red + ((warp + k) * 16 + gq + 8 * r) * D + dn * 8 + 2 * tq);
            acc[dn][2 * r] += o.x;
            acc[dn][2 * r + 1] += o.y;
          }
      }
    }
  }

  if (kg != 0 || !wlive) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + gq + 8 * r;
    if (row >= tile_rows) continue;
    const int grow = r0 + row;
    if constexpr (kPartial) {
      const long long at =
          (((long long)b * g.h_kv + h) * g.n_split + split) * g.rows + grow;
      float* pa = part_acc + at * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        store2(pa + dn * 8 + 2 * tq, acc[dn][2 * r], acc[dn][2 * r + 1]);
      if (tq == 0) {
        part_ml[at] = m_r[r];
        part_ml[n_part + at] = l_r[r];
      }
    } else {
      const int t = grow / n_rep, head = h * n_rep + (grow - t * n_rep);
      const float l = fmaxf(l_r[r], 1e-30f);
      QT* o = out + (((long long)b * g.T + t) * g.H + head) * Dl;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        if (dn * 8 >= Dl) break;              // a padded head's columns
        store2(o + dn * 8 + 2 * tq, acc[dn][2 * r] / l,
               acc[dn][2 * r + 1] / l);
      }
    }
  }
}

// Design 2's second pass: one CTA per (row, kv head, sequence), one thread
// per d < Dl (scratch rows are D_pad wide); the splits merge in split
// order. A split that saw no key of a row (m = -inf) adds nothing; a row
// no split saw returns 0. With ``lse`` (B5's stats, (B, H, T) f32) thread 0
// also writes the row's natural-log log-sum-exp of its scaled scores: m + ln
// l for f32 results (base e), (m + log2 l) ln 2 for bf16 ones (base 2, the
// scale carrying log2 e); -inf for a row no split saw.
template <typename QT, int D>
__global__ void __launch_bounds__(D)
combine_splits(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, QT* __restrict__ out,
               float* __restrict__ lse, Geo g) {
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const long long n_part = (long long)gridDim.z * g.h_kv * g.n_split * g.rows;
  const long long base = ((long long)b * g.h_kv + h) * g.n_split;
  float M = -INFINITY;
  for (int s = 0; s < g.n_split; ++s)
    M = fmaxf(M, part_ml[(base + s) * g.rows + row]);
  float a = 0.f, l = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < g.n_split; ++s) {
      const long long at = (base + s) * g.rows + row;
      const float ms = part_ml[at];
      if (ms == -INFINITY) continue;
      const float f = ex<sizeof(QT) == 4>(ms - M);
      l += part_ml[n_part + at] * f;
      a += part_acc[at * D + d] * f;
    }
  }
  const int t = row / g.n_rep, head = h * g.n_rep + (row - t * g.n_rep);
  store_as(out + (((long long)b * g.T + t) * g.H + head) * g.D + d,
           a / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) {
    float v = -INFINITY;
    if (M != -INFINITY)
      v = sizeof(QT) == 4 ? M + logf(l)
                          : (M + log2f(l)) * 0.6931471805599453f;
    lse[((long long)b * g.H + head) * g.T + t] = v;
  }
}

template <typename QT, typename KT, typename ST, int D, int KS, bool kPartial,
          bool kContig>
int launch(const Args& a, const Geo& g, int B, cudaStream_t stream) {
  using L = Layout<QT, KT, D, KS, kPartial>;
  auto kern = paged_tile_kernel<QT, KT, ST, D, KS, kPartial, kContig>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::BYTES));
    if (e == cudaSuccess)      // all of L1 as shared memory: 2 CTAs an SM
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          int(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return int(e);
    smem_set = true;
  }
  const int row_tiles = (g.rows + L::TR - 1) / L::TR;
  const dim3 grid(row_tiles * g.n_split, g.h_kv, B);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const ST*>(a.ks),
      static_cast<const ST*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.kv_len), static_cast<QT*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml), g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !kPartial) return int(e);
  combine_splits<QT, D><<<dim3(g.rows, g.h_kv, B), g.D, 0, stream>>>(
      static_cast<const float*>(a.part_acc),
      static_cast<const float*>(a.part_ml), static_cast<QT*>(a.out),
      static_cast<float*>(a.lse), g);
  return int(cudaGetLastError());
}

// design 1 over pages (key split 1); design 2 over a contiguous cache or
// pages with the key split the pool fixes, or, for int8 pages at D_pad
// <= 128, the key split 1, 2 or 4 the caller's plan picks from the rows
template <typename QT, typename KT, typename ST, int D>
int by_design(const Args& a, const Geo& g, int B, int key_split,
              bool partial, bool contig, cudaStream_t s) {
  constexpr int F = kFixedSplit<KT>;
  if (!partial)
    return key_split == 1 && !contig
               ? launch<QT, KT, ST, D, 1, false, false>(a, g, B, s)
               : int(cudaErrorInvalidValue);
  if (key_split == F)
    return contig ? launch<QT, KT, ST, D, F, true, true>(a, g, B, s)
                  : launch<QT, KT, ST, D, F, true, false>(a, g, B, s);
  if constexpr (sizeof(KT) == 1 && D <= 128) {
    if (!contig && key_split == 1)
      return launch<QT, KT, ST, D, 1, true, false>(a, g, B, s);
    if (!contig && key_split == 2)
      return launch<QT, KT, ST, D, 2, true, false>(a, g, B, s);
  }
  return int(cudaErrorInvalidValue);
}

// the tile width a head dim runs on, or 0 where D is not a multiple of 16
// in [16, 256]
int d_pad(int D) {
  if (D < 16 || D > 256 || D % 16) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

template <typename QT, typename KT, typename ST>
int by_dim(const Args& a, const Geo& g, int B, int key_split, bool partial,
           bool contig, cudaStream_t s) {
  switch (d_pad(g.D)) {
    case 64:
      return by_design<QT, KT, ST, 64>(a, g, B, key_split, partial, contig, s);
    case 128:
      return by_design<QT, KT, ST, 128>(a, g, B, key_split, partial, contig,
                                        s);
    case 256:
      return by_design<QT, KT, ST, 256>(a, g, B, key_split, partial, contig,
                                        s);
  }
  return int(cudaErrorInvalidValue);
}

// the (q, pool, scale) dtypes of pair I: the parts' order
template <int I> struct Pair;
template <> struct Pair<0> {
  using Q = float; using K = float; using S = float; };
template <> struct Pair<1> {
  using Q = float; using K = __nv_bfloat16; using S = float; };
template <> struct Pair<2> {
  using Q = float; using K = int8_t; using S = float; };
template <> struct Pair<3> {
  using Q = float; using K = int8_t; using S = __nv_bfloat16; };
template <> struct Pair<4> {
  using Q = __nv_bfloat16; using K = float; using S = float; };
template <> struct Pair<5> {
  using Q = __nv_bfloat16; using K = __nv_bfloat16; using S = float; };
template <> struct Pair<6> {
  using Q = __nv_bfloat16; using K = int8_t; using S = float; };
template <> struct Pair<7> {
  using Q = __nv_bfloat16; using K = int8_t; using S = __nv_bfloat16; };

#ifndef PAGED_TILES_PAIR      // the C interface's part
// pair index of a q dtype and a pool (int8 pools by their scales' dtype)
int pair_of(int q_dtype, int kv_dtype, int sc_dtype) {
  const int q = q_dtype == kF32 ? 0 : q_dtype == kBF16 ? 4 : -1;
  const int pool = kv_dtype == kF32 ? 0 : kv_dtype == kBF16 ? 1
                   : kv_dtype == kI8 && sc_dtype == kF32 ? 2
                   : kv_dtype == kI8 && sc_dtype == kBF16 ? 3 : -1;
  return q < 0 || pool < 0 ? -1 : q + pool;
}

int by_pair(const Args& a, const Geo& g, int B, int q_dtype, int kv_dtype,
            int sc_dtype, int key_split, bool partial, bool contig,
            cudaStream_t s) {
  using tile_parts::pair_entry;
  switch (pair_of(q_dtype, kv_dtype, sc_dtype)) {
    case 0: return pair_entry<0>(a, g, B, key_split, partial, contig, s);
    case 1: return pair_entry<1>(a, g, B, key_split, partial, contig, s);
    case 2: return pair_entry<2>(a, g, B, key_split, partial, contig, s);
    case 3: return pair_entry<3>(a, g, B, key_split, partial, contig, s);
    case 4: return pair_entry<4>(a, g, B, key_split, partial, contig, s);
    case 5: return pair_entry<5>(a, g, B, key_split, partial, contig, s);
    case 6: return pair_entry<6>(a, g, B, key_split, partial, contig, s);
    case 7: return pair_entry<7>(a, g, B, key_split, partial, contig, s);
  }
  return int(cudaErrorInvalidValue);
}

template <typename QT, typename KT, int D>
long long bytes_for(int key_split, bool partial) {
  constexpr int F = kFixedSplit<KT>;
  if (!partial)
    return key_split == 1 ? (long long)Layout<QT, KT, D, 1, false>::BYTES : -1;
  if (key_split == F) return (long long)Layout<QT, KT, D, F, true>::BYTES;
  if constexpr (sizeof(KT) == 1 && D <= 128) {
    if (key_split == 1) return (long long)Layout<QT, KT, D, 1, true>::BYTES;
    if (key_split == 2) return (long long)Layout<QT, KT, D, 2, true>::BYTES;
  }
  return -1;
}

template <typename QT, typename KT>
long long bytes_by_dim(int D, int key_split, bool partial) {
  switch (d_pad(D)) {
    case 64: return bytes_for<QT, KT, 64>(key_split, partial);
    case 128: return bytes_for<QT, KT, 128>(key_split, partial);
    case 256: return bytes_for<QT, KT, 256>(key_split, partial);
  }
  return -1;
}

template <typename QT>
long long bytes_by_pool(int kv_dtype, int D, int key_split, bool partial) {
  if (kv_dtype == kF32) return bytes_by_dim<QT, float>(D, key_split, partial);
  if (kv_dtype == kBF16)
    return bytes_by_dim<QT, __nv_bfloat16>(D, key_split, partial);
  if (kv_dtype == kI8) return bytes_by_dim<QT, int8_t>(D, key_split, partial);
  return -1;
}

}  // namespace

extern "C" {

// Shared memory one CTA of the tile kernel needs (dynamic plus static), or
// -1 for a combination it does not take (a head dim off the rule, a key
// split it is not built for). split: design 2.
long long paged_tiles_smem_bytes(int q_dtype, int kv_dtype, int D,
                                 int key_split, int split) {
  long long n = -1;
  if (q_dtype == kF32)
    n = bytes_by_pool<float>(kv_dtype, D, key_split, split != 0);
  if (q_dtype == kBF16)
    n = bytes_by_pool<__nv_bfloat16>(kv_dtype, D, key_split, split != 0);
  return n < 0 ? n : n + (long long)kStaticSmem;
}

const char* paged_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1, B2 and B4 (pages through the table) and B5 (contig: a cache, table
// null, bs 1, nb S; design 2 only). The caller's plan gives key_split,
// n_split and split_pages; part_acc and part_ml are design 2's scratch
// (null for design 1): (B, h_kv, n_split, rows, D_pad) and (2, B, h_kv,
// n_split, rows) f32. lse: null, or design 2's (B, H, T) f32 log-sum-exp
// of each row (B5 with its stats).
int paged_tiles(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* table,
                const void* kv_len, void* out, void* part_acc, void* part_ml,
                void* lse,
                int q_dtype, int kv_dtype, int sc_dtype, int contig, int B,
                int T, int H, int h_kv, int D, int bs, int nb, int window,
                float scale, int key_split, int n_split, int split_pages,
                long long q_sb, long long q_st, long long q_sh,
                long long kv_sp, long long kv_ss, long long kv_sh,
                long long sc_sp, long long sc_ss, long long sc_sh,
                void* stream) {
  Geo g;
  g.T = T; g.H = H; g.h_kv = h_kv; g.D = D; g.bs = bs; g.nb = nb;
  g.window = window;
  g.n_rep = H / h_kv;
  g.rows = T * g.n_rep;
  g.n_split = n_split; g.split_pages = split_pages;
  g.scale = scale;
  g.q_sb = q_sb; g.q_st = q_st; g.q_sh = q_sh;
  g.kv_sp = kv_sp; g.kv_ss = kv_ss; g.kv_sh = kv_sh;
  g.sc_sp = sc_sp; g.sc_ss = sc_ss; g.sc_sh = sc_sh;
  const Args a{q, k, v, k_scale, v_scale, table, kv_len, out, part_acc,
               part_ml, lse};
  if (lse != nullptr && part_acc == nullptr) return int(cudaErrorInvalidValue);
  const bool partial = part_acc != nullptr;
  return by_pair(a, g, B, q_dtype, kv_dtype, sc_dtype, key_split, partial,
                 contig != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

#else                         // pair PAGED_TILES_PAIR's part
}  // namespace

namespace tile_parts {

template <int I>
int pair_entry(const Args& a, const Geo& g, int B, int key_split,
               bool partial, bool contig, cudaStream_t s) {
  using P = Pair<I>;
  return by_dim<typename P::Q, typename P::K, typename P::S>(
      a, g, B, key_split, partial, contig, s);
}

template int pair_entry<PAGED_TILES_PAIR>(const Args&, const Geo&, int, int,
                                          bool, bool, cudaStream_t);

}  // namespace tile_parts
#endif
