// Mamba-2 SSD chunked scan from the zero state for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   B6 src/repro/kernels/ssd_scan.py  ssd_scan
//
// What it computes: for each (sequence b, head) the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t . h_t,
// h_{-1} = 0, in the chunked (state-space-duality) form: per chunk of
// `chunk` positions, with cum = the running sum of dt A inside the chunk,
//   y_t  = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
//        + exp(cum_t) C_t . h_prev
//   h    = exp(cum_end) h_prev + sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
// and writes y (B, S, nh, P) and the final state h (B, nh, P, N) in x's
// dtype. Positions past S are the reference's zero padding: the last chunk
// is ragged and stops at S (nothing past it is read). dt >= 0 and A <= 0,
// so cum never increases; it is summed in position order, so every
// exponent the kernels take is <= 0 (the masked s > t differences are
// never used: they overflow, and inf * 0 is NaN).
//
// What bounds it on the H100: at mamba2-780m's prefill shapes (P 64, N
// 128, chunk 128) the work is about 170 flop a byte moved, under the
// tensor cores' ~295 flop/byte ridge: bytes bound it (~4.2 us at B 1,
// S 1024). What a call costs beyond that is its three launches, the f32
// chunk states it writes and reads back (12.6 MB at S 1024, mostly in
// L2), and the chunks' serial hand-over of the state.
//
// What this design does about it: three kernels, parallel over chunks.
//   1. ssd_chunk, one CTA a (b, chunk, head): the head's cumsum of dt A in
//      position order (one thread; the chunk's heads in parallel CTAs) and
//      the chunk's own state sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
//      (P x N f32) into a workspace; beside them, 8 CTAs a (b, chunk) form
//      C B^T (chunk x chunk f32, its lower block triangle, 16 rows each)
//      once for all heads of the chunk.
//   2. ssd_pass, parallel over (b, head, P * N): h_c = exp(total_c) h_{c-1}
//      + s_c in chunk order, four chunks' loads at a time; the workspace
//      then holds the state entering each chunk, and h the final state.
//   3. ssd_out, one CTA a (b, chunk, head): y = (C B^T . exp(cum_t -
//      cum_s) dt_s, s <= t) x + exp(cum_t) C h_prev^T.
//   At B 1, S 1024 kernels 1 and 3 run 8 x 48 = 384 head CTAs each. Every
//   product runs on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   f32 sums) fed by ldmatrix from rows padded by 16 bytes (no bank
//   conflicts): bf16 x, B and C are exact operands; an operand formed in
//   f32 (the decay-weighted x, the masked scores, the state) enters as
//   three bf16 pieces that sum to it (24 bits: two pieces, 16 bits, moved
//   phase 9's 48-layer bf16 logits past its bound against the plain
//   version). f32 inputs enter as three pieces too; of the piece products
//   those whose orders sum below three are kept, each 16-wide step starts
//   from zero and is added in f32 (the tensor cores truncate long sums).
//   bf16 x, B and C rows are staged with cp.async 16-byte copies through
//   their strides (x, B and C are views of one conv output in the model;
//   the Pallas wrapper's transpose is a copy this kernel does not make);
//   rows that are not 16-byte aligned, and f32 rows, go through registers.
// The kernels take P = 64, N = 128 and any chunk up to 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kP = 64, kN = 128, kCH = 128;   // head dim, state dim, rows
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kPitchN = kN + 8;               // bf16 a staged row of N
constexpr int kPitchP = kP + 8;               // bf16 a staged row of P
constexpr int kRowsN = kCH * kPitchN;         // one plane of (chunk, N)
constexpr int kRowsP = kCH * kPitchP;         // one plane of (chunk, P)
constexpr int kStateN = kP * kPitchN;         // one plane of (P, N)

enum DType { kF32 = 0, kBF16 = 1 };

// pieces of an operand formed in f32 (24 bits: a bf16 result stays as
// close to the plain version's f32 sums as a kernel in f32 would)
constexpr int kFormed = 3;

struct Geometry {
  int B, S, nh, chunk, nc;
  long long x_sb, x_ss, x_sh;                // x strides (elements); p contiguous
  long long dt_sb, dt_ss, dt_sh;             // dt strides
  long long b_sb, b_ss;                      // B strides; n contiguous
  long long c_sb, c_ss;                      // C strides; n contiguous
};

template <int NA, int NB>
__device__ __forceinline__ void piece_products(float (&c)[4],
                                               const uint32_t (&a)[NA][4],
                                               const uint32_t (&b)[NB][2]) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int s = kMax - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (s - i >= 0 && s - i < NB) mma(c, a[i], b[s - i][0], b[s - i][1]);
}

// c += a . b over the products of pieces whose orders sum below the larger
// count, smallest first; with three pieces the step starts from zero and
// is added in f32
template <int NA, int NB>
__device__ __forceinline__ void mma_pieces(float (&c)[4],
                                           const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][2]) {
  if constexpr ((NA > NB ? NA : NB) == 3) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    piece_products<NA, NB>(t, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
  } else {
    piece_products<NA, NB>(c, a, b);
  }
}

// Rows [0, rows) of `cols` elements, row r read from src + r * stride (the
// row itself contiguous), rows >= n zero-filled and never read, into
// Pieces<T> bf16 planes at dst (row pitch `pitch`, planes `plane` apart).
// bf16 rows that are 16-byte aligned go by cp.async (the caller commits
// and waits); the others through registers (f32 split into pieces).
template <typename T, int cols>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int pitch,
                                           int plane, const T* src,
                                           long long stride, int n, int rows,
                                           bool async) {
  constexpr int kChunks = cols / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool on = r < n;
    const T* s = src + (on ? r * stride + 8 * cc : 0);
    __nv_bfloat16* d = dst + r * pitch + 8 * cc;
    if constexpr (sizeof(T) == 2) {
      if (async) {
        cp_async16(d, s, on);
      } else {
        const unsigned short* q = reinterpret_cast<const unsigned short*>(s);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = on ? (q[2 * i] | (uint32_t(q[2 * i + 1]) << 16)) : 0u;
        *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = on ? s[i] : 0.f;
      store8<Pieces<T>::n>(d, plane, v);
    }
  }
}

template <typename T>
constexpr size_t chunk_smem() {
  return size_t(Pieces<T>::n) * (kRowsP + kRowsN) * 2 + 2 * kCH * 4;
}
template <typename T>
constexpr size_t out_smem() {
  return size_t(Pieces<T>::n) * (kRowsP + kRowsN) * 2 +
         size_t(kFormed) * kStateN * 2 + 2 * kCH * 4;
}

// ---------------------------------------------------------------- chunk --

// grid (nc, nh + kCH / 16, B). CTAs y < nh take head y of the chunk: its
// cumsum of dt A in position order (one thread; the chunk's 48 heads in
// parallel CTAs) into cum_ws (B, nc, nh, kCH), and the chunk's own state
// sum_s exp(cum_end - cum_s) dt_s x_s B_s^T into st_ws (B, nc, nh, P, N).
// CTAs y = nh + r form rows 16 r .. 16 r + 15 of C B^T (columns s < 16 (r +
// 1), warp w columns 16 w ..) into cb_ws (B, nc, kCH, kCH): once a chunk,
// for all its heads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const T* __restrict__ Bm,
          const T* __restrict__ Cm, float* __restrict__ cum_ws,
          float* __restrict__ cb_ws, float* __restrict__ st_ws, Geometry g,
          bool async) {
  constexpr int NP = Pieces<T>::n, NF = kFormed;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int c = blockIdx.x, b = blockIdx.z;
  const int c0 = c * g.chunk, n = min(g.chunk, g.S - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, mat = lane >> 3;

  if (blockIdx.y >= g.nh) {                    // rows of C B^T
    const int t0 = 16 * (blockIdx.y - g.nh);
    if (t0 >= n) return;
    __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* bs = cs + NP * 16 * kPitchN;
    stage_rows<T, kN>(cs, kPitchN, 16 * kPitchN,
                      Cm + b * g.c_sb + (c0 + t0) * g.c_ss, g.c_ss, n - t0, 16,
                      async);
    stage_rows<T, kN>(bs, kPitchN, kRowsN, Bm + b * g.b_sb + c0 * g.b_ss,
                      g.b_ss, n, t0 + 16, async);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (16 * warp > t0) return;
    float acc[2][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[st][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      uint32_t a[NP][4], bb[NP][4], b0[NP][2], b1[NP][2];
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        ldsm_x4(a[pc], cs + pc * 16 * kPitchN +
                           ((mat & 1) * 8 + (lane & 7)) * kPitchN + 16 * ks +
                           (mat >> 1) * 8);
        ldsm_x4(bb[pc], bs + pc * kRowsN +
                            (16 * warp + (mat >> 1) * 8 + (lane & 7)) * kPitchN +
                            16 * ks + (mat & 1) * 8);
        b0[pc][0] = bb[pc][0]; b0[pc][1] = bb[pc][1];
        b1[pc][0] = bb[pc][2]; b1[pc][1] = bb[pc][3];
      }
      mma_pieces<NP, NP>(acc[0], a, b0);
      mma_pieces<NP, NP>(acc[1], a, b1);
    }
    float* cbw = cb_ws + ((long long)b * g.nc + c) * kCH * kCH;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int s = 16 * warp + 8 * st + 2 * tq;
      store2(cbw + (t0 + gq) * kCH + s, acc[st][0], acc[st][1]);
      store2(cbw + (t0 + gq + 8) * kCH + s, acc[st][2], acc[st][3]);
    }
    return;
  }

  const int h = blockIdx.y;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bs = xs + NP * kRowsP;
  float* w = reinterpret_cast<float*>(bs + NP * kRowsN);
  float* cum = w + kCH;
  stage_rows<T, kP>(xs, kPitchP, kRowsP,
                    x + b * g.x_sb + c0 * g.x_ss + h * g.x_sh, g.x_ss, n, kCH,
                    async);
  stage_rows<T, kN>(bs, kPitchN, kRowsN, Bm + b * g.b_sb + c0 * g.b_ss,
                    g.b_ss, n, kCH, async);
  cp_async_commit();
  // while the rows land: dt, its cumsum in position order, and the weights
  // exp(cum_end - cum_s) dt_s
  for (int i = threadIdx.x; i < kCH; i += kThreads)
    w[i] = i < n ? dt[b * g.dt_sb + (c0 + i) * g.dt_ss + h * g.dt_sh] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float a = A[h];
    float run = 0.f;
    for (int i = 0; i < n; ++i) {
      run += w[i] * a;
      cum[i] = run;
    }
  }
  __syncthreads();
  float* cw = cum_ws + (((long long)b * g.nc + c) * g.nh + h) * kCH;
  for (int i = threadIdx.x; i < kCH; i += kThreads) {
    if (i < n) cw[i] = cum[i];
    w[i] = i < n ? expf(cum[n - 1] - cum[i]) * w[i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // (w x)^T (P x s) . B (s x N): warp w owns p rows 16 (w & 3) .. and n
  // columns 64 (w >> 2) ..
  const int p0 = 16 * (warp & 3), nb = 64 * (warp >> 2);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kCH / 16; ++ks) {
    if (16 * ks >= n) break;
    // A[p][s] = w_s x[s][p]: register i holds (p, s), (p, s + 1) with
    // (p, s) = (g, 2tq), (g + 8, 2tq), (g, 2tq + 8), (g + 8, 2tq + 8)
    uint32_t xr[NP][4];
#pragma unroll
    for (int pc = 0; pc < NP; ++pc)
      ldsm_x4_trans(xr[pc], xs + pc * kRowsP +
                                (16 * ks + (mat >> 1) * 8 + (lane & 7)) * kPitchP +
                                p0 + (mat & 1) * 8);
    const int s = 16 * ks + 2 * tq;
    uint32_t a[NF][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        v0 += bf16_lo(xr[pc][i]);
        v1 += bf16_hi(xr[pc][i]);
      }
      const int si = s + (i >> 1) * 8;
      uint32_t pcs[NF];
      pieces2<NF>(v0 * w[si], v1 * w[si + 1], pcs);
#pragma unroll
      for (int f = 0; f < NF; ++f) a[f][i] = pcs[f];
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[NP][4], b0[NP][2], b1[NP][2];
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        ldsm_x4_trans(bb[pc], bs + pc * kRowsN +
                                  (16 * ks + (mat & 1) * 8 + (lane & 7)) * kPitchN +
                                  nb + 16 * np + (mat >> 1) * 8);
        b0[pc][0] = bb[pc][0]; b0[pc][1] = bb[pc][1];
        b1[pc][0] = bb[pc][2]; b1[pc][1] = bb[pc][3];
      }
      mma_pieces<NF, NP>(acc[2 * np], a, b0);
      mma_pieces<NF, NP>(acc[2 * np + 1], a, b1);
    }
  }
  float* sw = st_ws + (((long long)b * g.nc + c) * g.nh + h) * kP * kN;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nb + 8 * nt + 2 * tq;
    store2(sw + (p0 + gq) * kN + col, acc[nt][0], acc[nt][1]);
    store2(sw + (p0 + gq + 8) * kN + col, acc[nt][2], acc[nt][3]);
  }
}

// ----------------------------------------------------------------- pass --

// grid (P * N / 256, nh, B): h_c = exp(total_c) h_{c-1} + s_c in chunk
// order; st_ws[c] becomes the state entering chunk c, h_out the last.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_pass(const float* __restrict__ cum_ws, float* __restrict__ st_ws,
         T* __restrict__ h_out, Geometry g) {
  const int e = blockIdx.x * 256 + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  float run = 0.f;
  for (int c0 = 0; c0 < g.nc; c0 += 4) {       // four chunks' loads at once
    float s[4], decay[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= g.nc) break;
      const long long bch = ((long long)b * g.nc + c) * g.nh + h;
      s[j] = st_ws[bch * kP * kN + e];
      decay[j] = cum_ws[bch * kCH + min(g.chunk, g.S - c * g.chunk) - 1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= g.nc) break;
      st_ws[(((long long)b * g.nc + c) * g.nh + h) * kP * kN + e] = run;
      run = fmaf(expf(decay[j]), run, s[j]);
    }
  }
  store_as(h_out + ((long long)b * g.nh + h) * kP * kN + e, run);
}

// ------------------------------------------------------------------ out --

// grid (nc, nh, B): y of one (b, chunk, head); warp w owns rows 16 w ..
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_out(const T* __restrict__ x, const float* __restrict__ dt,
        const T* __restrict__ Cm, const float* __restrict__ cum_ws,
        const float* __restrict__ cb_ws, const float* __restrict__ st_ws,
        T* __restrict__ y, Geometry g, bool async) {
  constexpr int NP = Pieces<T>::n, NF = kFormed;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* cs = xs + NP * kRowsP;
  __nv_bfloat16* hs = cs + NP * kRowsN;
  float* cum = reinterpret_cast<float*>(hs + NF * kStateN);
  float* dts = cum + kCH;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * g.chunk, n = min(g.chunk, g.S - c0);
  stage_rows<T, kP>(xs, kPitchP, kRowsP,
                    x + b * g.x_sb + c0 * g.x_ss + h * g.x_sh, g.x_ss, n, kCH,
                    async);
  stage_rows<T, kN>(cs, kPitchN, kRowsN, Cm + b * g.c_sb + c0 * g.c_ss,
                    g.c_ss, n, kCH, async);
  cp_async_commit();
  const long long bch = ((long long)b * g.nc + c) * g.nh + h;
  if (c > 0) {                                // the state entering the chunk
    const float* sw = st_ws + bch * kP * kN;
    for (int i = threadIdx.x; i < kP * kN / 8; i += kThreads) {
      const int r = i / (kN / 8), cc = i % (kN / 8);
      const float4 u = *reinterpret_cast<const float4*>(sw + r * kN + 8 * cc);
      const float4 v = *reinterpret_cast<const float4*>(sw + r * kN + 8 * cc + 4);
      const float f[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      store8<NF>(hs + r * kPitchN + 8 * cc, kStateN, f);
    }
  }
  for (int i = threadIdx.x; i < kCH; i += kThreads) {
    cum[i] = i < n ? cum_ws[bch * kCH + i] : 0.f;
    dts[i] = i < n ? dt[b * g.dt_sb + (c0 + i) * g.dt_ss + h * g.dt_sh] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, mat = lane >> 3;
  const int t0 = 16 * warp;
  if (t0 >= n) return;
  float yi[8][4], ya[8][4];
#pragma unroll
  for (int pt = 0; pt < 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[pt][e] = ya[pt][e] = 0.f;

  if (c > 0) {                                // C h_prev^T (t x P)
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      uint32_t a[NP][4];
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
        ldsm_x4(a[pc], cs + pc * kRowsN +
                           (t0 + (mat & 1) * 8 + (lane & 7)) * kPitchN +
                           16 * ks + (mat >> 1) * 8);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t bb[NF][4], b0[NF][2], b1[NF][2];
#pragma unroll
        for (int pc = 0; pc < NF; ++pc) {
          ldsm_x4(bb[pc], hs + pc * kStateN +
                              (16 * pp + (mat >> 1) * 8 + (lane & 7)) * kPitchN +
                              16 * ks + (mat & 1) * 8);
          b0[pc][0] = bb[pc][0]; b0[pc][1] = bb[pc][1];
          b1[pc][0] = bb[pc][2]; b1[pc][1] = bb[pc][3];
        }
        mma_pieces<NP, NF>(yi[2 * pp], a, b0);
        mma_pieces<NP, NF>(yi[2 * pp + 1], a, b1);
      }
    }
  }

  // (C B^T . exp(cum_t - cum_s) dt_s, s <= t) x, blocks of 16 s up to the
  // diagonal; register i of the scores holds (t, s), (t, s + 1) with
  // (t, s) = (tA, 2tq), (tB, 2tq), (tA, 2tq + 8), (tB, 2tq + 8)
  const int tA = t0 + gq, tB = tA + 8;
  const float* cbw = cb_ws + ((long long)b * g.nc + c) * kCH * kCH;
  float2 cbn[4];                               // C B^T of the next block
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cbn[i] = *reinterpret_cast<const float2*>(
        cbw + ((i & 1) ? tB : tA) * kCH + 2 * tq + (i >> 1) * 8);
#pragma unroll
  for (int kb = 0; kb < kCH / 16; ++kb) {
    if (kb > warp) break;
    float2 cbv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cbv[i] = cbn[i];
      if (kb < warp)
        cbn[i] = *reinterpret_cast<const float2*>(
            cbw + ((i & 1) ? tB : tA) * kCH + 16 * (kb + 1) + 2 * tq + (i >> 1) * 8);
    }
    uint32_t a[NF][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = (i & 1) ? tB : tA;
      const int s = 16 * kb + 2 * tq + (i >> 1) * 8;
      const float2 v = cbv[i];
      const bool row = t < n;
      // only s <= t is used; the clamp keeps a speculated exponent <= 0
      const float e0 = (row && s <= t)
                           ? v.x * expf(fminf(cum[t] - cum[s], 0.f)) * dts[s]
                           : 0.f;
      const float e1 = (row && s + 1 <= t)
                           ? v.y * expf(fminf(cum[t] - cum[s + 1], 0.f)) * dts[s + 1]
                           : 0.f;
      uint32_t pcs[NF];
      pieces2<NF>(e0, e1, pcs);
#pragma unroll
      for (int f = 0; f < NF; ++f) a[f][i] = pcs[f];
    }
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      uint32_t bb[NP][4], b0[NP][2], b1[NP][2];
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        ldsm_x4_trans(bb[pc], xs + pc * kRowsP +
                                  (16 * kb + (mat & 1) * 8 + (lane & 7)) * kPitchP +
                                  16 * pp + (mat >> 1) * 8);
        b0[pc][0] = bb[pc][0]; b0[pc][1] = bb[pc][1];
        b1[pc][0] = bb[pc][2]; b1[pc][1] = bb[pc][3];
      }
      mma_pieces<NF, NP>(ya[2 * pp], a, b0);
      mma_pieces<NF, NP>(ya[2 * pp + 1], a, b1);
    }
  }

  const float eA = expf(cum[tA]), eB = expf(cum[tB]);
  T* yb = y + ((long long)b * g.S + c0) * g.nh * kP + (long long)h * kP;
  const long long y_st = (long long)g.nh * kP;
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
    const int p = 8 * pt + 2 * tq;
    if (tA < n)
      store2(yb + tA * y_st + p, fmaf(eA, yi[pt][0], ya[pt][0]),
             fmaf(eA, yi[pt][1], ya[pt][1]));
    if (tB < n)
      store2(yb + tB * y_st + p, fmaf(eB, yi[pt][2], ya[pt][2]),
             fmaf(eB, yi[pt][3], ya[pt][3]));
  }
}

template <typename Kern>
int allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h, void* cum_ws, void* cb_ws,
           void* st_ws, const Geometry& g, bool async, cudaStream_t s) {
  static bool ready = false;                 // shared-memory opt-ins made
  if (!ready) {
    int e = allow_smem(ssd_chunk<T>, chunk_smem<T>());
    if (!e) e = allow_smem(ssd_out<T>, out_smem<T>());
    if (e) return e;
    ready = true;
  }
  const T* xp = static_cast<const T*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const T* cp = static_cast<const T*>(Cm);
  float* cum = static_cast<float*>(cum_ws);
  float* cb = static_cast<float*>(cb_ws);
  float* st = static_cast<float*>(st_ws);
  ssd_chunk<T><<<dim3(g.nc, g.nh + kCH / 16, g.B), kThreads, chunk_smem<T>(),
                 s>>>(xp, dtp, static_cast<const float*>(A),
                      static_cast<const T*>(Bm), cp, cum, cb, st, g, async);
  int e = int(cudaGetLastError());
  if (e) return e;
  ssd_pass<T><<<dim3(kP * kN / 256, g.nh, g.B), 256, 0, s>>>(
      cum, st, static_cast<T*>(h), g);
  e = int(cudaGetLastError());
  if (e) return e;
  ssd_out<T><<<dim3(g.nc, g.nh, g.B), kThreads, out_smem<T>(), s>>>(
      xp, dtp, cp, cum, cb, st, static_cast<T*>(y), g, async);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B6: x, B and C in one dtype (f32 or bf16), dt and A f32; y and h out in
// x's dtype, contiguous. Workspaces (f32, from the caller): cum_ws (B, nc,
// nh, 128), cb_ws (B, nc, 128, 128), st_ws (B, nc, nh, P, N), nc =
// ceil(S / chunk). aligned: bf16 x, B and C rows 16-byte aligned through
// the pointers and strides (cp.async staging). P = 64, N = 128, 1 <= chunk
// <= 128 (the caller checks). Launches three kernels on `stream`; returns
// the first CUDA error code.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* h, void* cum_ws, void* cb_ws,
             void* st_ws, int x_dtype, int B, int S, int nh, int P, int N,
             int chunk, int aligned, long long x_sb, long long x_ss,
             long long x_sh, long long dt_sb, long long dt_ss,
             long long dt_sh, long long b_sb, long long b_ss,
             long long c_sb, long long c_ss, void* stream) {
  if (P != kP || N != kN || chunk < 1 || chunk > kCH || B < 1 || S < 1 ||
      nh < 1)
    return int(cudaErrorInvalidValue);
  Geometry g;
  g.B = B; g.S = S; g.nh = nh; g.chunk = chunk; g.nc = (S + chunk - 1) / chunk;
  g.x_sb = x_sb; g.x_ss = x_ss; g.x_sh = x_sh;
  g.dt_sb = dt_sb; g.dt_ss = dt_ss; g.dt_sh = dt_sh;
  g.b_sb = b_sb; g.b_ss = b_ss; g.c_sb = c_sb; g.c_ss = c_ss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch<float>(x, dt, A, Bm, Cm, y, h, cum_ws, cb_ws, st_ws, g,
                         false, s);
  if (x_dtype == kBF16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, cum_ws, cb_ws, st_ws,
                                 g, aligned != 0, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
