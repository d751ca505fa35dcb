// W4A16 grouped matmul for Hopper (sm_90a): out (M, N) f32 =
//   x (M, K) f32|bf16  @  dequant(packed (K/2, N) int8, scale (K/g, N) bf16)
//
// Replaces the Pallas TPU kernel
//   B3 src/repro/kernels/q4_matmul.py  q4_matmul  (pl.pallas_call at :81)
// whose oracle is src/repro/kernels/ref.py q4_matmul_ref.
//
// What it computes: packed byte (r, n) holds weight row 2r in its low nibble
// and row 2r+1 in its high nibble, 4-bit two's complement. Weight (k, n) is
// that nibble times scale[k / g, n]; the product with x is summed over k in
// f32. The Pallas kernel dequantizes a tile into VMEM and carries the output
// tile across its sequential k axis; here blocks run in no order, so a call
// cuts K into splits (whole groups each) that run as separate CTAs and are
// summed afterwards in split order.
//
// What bounds it on the H100: bytes at decode, operations at prefill. At
// M <= 16 every packed byte feeds at most 32 multiply-adds, far under the
// ~295 flop/byte ridge: the least time is (K/2*N + 2*K/g*N + x + out bytes)
// / 3.35 TB/s, ~11.4 us for a qwen2.5-14b (5120, 13824) projection at M = 8.
// At prefill (M = hundreds of prompt rows) the 2*M*K*N operations bound it.
//
// What this design does about it: one kernel template, two paths.
//   * The products run on the tensor cores (mma.sync m16n8k16, bf16
//     operands, f32 sums) with the weight as the A operand (16 columns of
//     W^T) and x as B (8 rows of x^T). A nibble q in [-8, 7] is exact in
//     bf16: one lop3 puts q ^ 8 into the mantissa of 128.0 (bits 0x4300,
//     giving 136 + q), a byte-permute pairs a byte's two nibbles and one
//     bf16x2 fma subtracts 136, so a packed byte becomes the bf16 pair (row
//     2r, row 2r+1) of one column -- exactly the two k values one A
//     register holds. bf16 x times q is exact; f32 x enters as three bf16
//     pieces that sum to it (hi + mid + lo), each product exact.
//   * Each group's partial starts from zero in the MMA fragment (the tensor
//     cores truncate long sums), and scale[g, n] times the partial is added
//     to an f32 accumulator outside the MMA, in group order. Only packed
//     bytes and bf16 scales cross HBM; no dequantized weight is written.
//   * A CTA of 4 warps owns 128 columns (a warp 32, a lane group 4: one
//     4-byte read of a staged packed row) and 8, 16 or 64 rows of x, and
//     streams its split of K through a cp.async ring in shared memory:
//     stages of 64 k, each the x rows, the 32 packed rows of the 128
//     columns and the scale rows of the groups it touches (rows padded:
//     ldmatrix and the packed reads are free of bank conflicts). Each warp
//     converts its columns' weights once a stage and runs them against
//     every row of the CTA.
//   * Decode (M <= 16 rows at a time -- every decode and verify step -- and
//     f32 x at any M): bound by bytes. 8 or 16 rows, a ring of 4 stages;
//     K is split to about 8 CTAs an SM (more bytes in flight), and at
//     M <= 16 the split comes from K and N alone, so a row sums in the
//     same order at every M <= 16: a verify row equals a decode step's.
//   * Tile (bf16 x, M > 16: prefill, chunks): bound by operations. 64 rows,
//     3 stages, at most 167 registers (3 CTAs an SM); K is split where the
//     tile grid is under 4 waves (e.g. M = 37, N = 1024).
//   * Splits are written to an f32 workspace and a second kernel adds them
//     in split index order, never in arrival order. One split writes the
//     output directly.
//   * Pointers or N that are not 16-byte aligned take the same kernels with
//     byte loads (the same arithmetic); rows past M and columns past N are
//     never loaded and never stored.
// What still bounds it (phase 2 of chip_smoke.py times it): at decode,
// about 2x the bytes' time (the stage's x and scale rows and the integer
// work of the conversion ride along with the weights); at prefill the
// conversion and the mma.sync rate, 4-5x cuBLAS on a dequantized weight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
enum Path { kDecode = 0, kTile = 1 };

__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;   // (a & b) ^ c in one lop3
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The four packed bytes of a word (one packed row, four columns) as four
// bf16x2 words, word i = (low nibble, high nibble) of byte i, exact in
// [-8, 7]: nibble u lands as u ^ 8 in the mantissa of 128.0 (136 + q) and
// 136 is subtracted by a bf16x2 fma (exact).
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t (&r)[4]) {
  constexpr uint32_t kMask = 0x000f000fu, kMagic = 0x43084308u;
  const uint32_t t0 = and_xor(w, kMask, kMagic);         // b0.lo, b2.lo
  const uint32_t t1 = and_xor(w >> 4, kMask, kMagic);    // b0.hi, b2.hi
  const uint32_t t2 = and_xor(w >> 8, kMask, kMagic);    // b1.lo, b3.lo
  const uint32_t t3 = and_xor(w >> 12, kMask, kMagic);   // b1.hi, b3.hi
  const uint32_t u[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t2, t3, 0x5410),
                         __byte_perm(t0, t1, 0x7632), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(r[i])
        : "r"(u[i]), "r"(0x3f803f80u), "r"(0xc308c308u));   // * 1 - 136
}

// ------------------------------------------------------------- loads ----

// 16 bytes from src to shared dst, of which the first `valid` exist (zero
// past them): by cp.async when aligned (valid is then >= 16 or <= 0; the
// caller commits), else through registers one byte at a time
template <bool kAligned>
__device__ __forceinline__ void stage16(void* dst, const void* src,
                                        int valid) {
  if constexpr (kAligned) {
    cp_async16(dst, src, valid > 0);
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(src);
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < valid) w[i >> 2] |= uint32_t(p[i]) << (8 * (i & 3));
    *static_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------- kernel --

constexpr int kThreads = 128, BN = 128;      // 4 warps of 32 columns
constexpr int kTK = 64;                      // k a stage
constexpr int kSRows = 4;                    // scale rows a stage can touch

// One CTA's ring. MT: m8 tiles of x rows (1 or 2 decode, 8 tile). x is
// staged XR rows deep (at least 16, for one ldmatrix.x4) with rows padded
// by 16 bytes; packed rows are padded to a pitch of 8 (mod 32) words so
// the lanes' 4-byte reads of four rows hit distinct banks. Decode keeps 4
// stages in flight, a tile 3.
template <typename T, int MT>
struct Cfg {
  static constexpr int kStages = MT == 8 ? 3 : 4;
  static constexpr int XR = MT * 8 < 16 ? 16 : MT * 8;
  static constexpr int XP = kTK + 16 / int(sizeof(T));      // elements
  static constexpr int PP = BN + 32;                         // bytes
  static constexpr int kXStage = XR * XP * int(sizeof(T));
  static constexpr int kPStage = (kTK / 2) * PP;
  static constexpr int kSStage = kSRows * BN * 2;
  static constexpr int kStage = kXStage + kPStage + kSStage;
  static constexpr int kBytes = kStages * kStage;
};

// grid (ceil(N / 128), ceil(M / (8 MT)), n_split). Warp w owns columns
// 32 w .. 32 w + 31 of the CTA's 128, lane group g columns 4g .. 4g + 3:
// MMA tile t takes column 4g + 2t as A row g and 4g + 2t + 1 as A row
// g + 8, against the CTA's 8 MT x rows as MT m8 tiles. Each stage of the
// ring holds kTK values of k: the x rows, the packed rows of the 128
// columns and the scale rows of the groups the stage touches. A tile
// keeps to 167 registers, so 3 CTAs share an SM. Rows past M
// and columns past N are never loaded: their (unused) outputs are the
// only ones they reach.
template <typename T, int MT, bool kAligned>
__global__ void __launch_bounds__(kThreads, MT == 8 ? 3 : 1)
q4_gemm(const T* __restrict__ x, const uint8_t* __restrict__ packed,
        const __nv_bfloat16* __restrict__ scale, float* __restrict__ dst,
        int M, int N, int K, int group, int n_split) {
  using C = Cfg<T, MT>;
  constexpr int S = C::kStages;
  constexpr int NP = Pieces<T>::n, BM = 8 * MT, XP = C::XP, PP = C::PP;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, mat = lane >> 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int G = K / group;
  const int k_lo = int((long long)split * G / n_split) * group;
  const int k_hi = int((long long)(split + 1) * G / n_split) * group;
  const int nblk = (k_hi - k_lo + kTK - 1) / kTK;
  const int rows = min(C::XR, M - m0);         // x rows to stage

  auto load = [&](int blk) {
    uint8_t* st = smem + (blk % S) * C::kStage;
    const int kb = k_lo + blk * kTK;
    const int kn = min(kTK, k_hi - kb);        // a multiple of 16
    constexpr int kEC = 16 / int(sizeof(T));   // elements a 16-byte chunk
    const int xc = kn / kEC;                   // chunks a row
    for (int c = tid; c < rows * xc; c += kThreads) {
      const int r = c / xc, cc = c - r * xc;
      stage16<kAligned>(st + (r * XP + cc * kEC) * int(sizeof(T)),
                        x + (long long)(m0 + r) * K + kb + cc * kEC, 16);
    }
    uint8_t* pd = st + C::kXStage;
    for (int c = tid; c < (kn / 2) * (BN / 16); c += kThreads) {
      const int r = c / (BN / 16), cc = c % (BN / 16);
      const int n = n0 + 16 * cc;
      if (n < N)
        stage16<kAligned>(pd + r * PP + 16 * cc,
                          packed + (long long)(kb / 2 + r) * N + n, N - n);
    }
    uint8_t* sd = pd + C::kPStage;
    const int g0 = kb / group, gn = (kb + kn - 1) / group - g0 + 1;
    for (int c = tid; c < gn * (BN / 8); c += kThreads) {
      const int r = c / (BN / 8), cc = c % (BN / 8);
      const int n = n0 + 8 * cc;
      if (n < N)
        stage16<kAligned>(sd + r * BN * 2 + 16 * cc,
                          scale + (long long)(g0 + r) * N + n, 2 * (N - n));
    }
  };

  float acc[2][MT][4], p[2][MT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = p[t][mt][e] = 0.f;

#pragma unroll
  for (int b = 0; b < S - 1; ++b) {
    if (b < nblk) load(b);
    cp_async_commit();
  }
  const int col = 32 * warp + 4 * g;           // this lane's four columns
  const int steps = group / 16;                // k16 steps a group
  int step = 0;                                // of the current group
  for (int b = 0; b < nblk; ++b) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (b + S - 1 < nblk) load(b + S - 1);
    cp_async_commit();
    const uint8_t* st = smem + (b % S) * C::kStage;
    const T* xd = reinterpret_cast<const T*>(st);
    const uint8_t* pd = st + C::kXStage + col;
    const uint8_t* sd = st + C::kXStage + C::kPStage + 2 * col;
    const int kb = k_lo + b * kTK;
    const int g0 = kb / group;
#pragma unroll
    for (int ks = 0; ks < kTK / 16; ++ks) {
      const int k0 = kb + 16 * ks;
      if (k0 >= k_hi) break;
      uint32_t ra[4], rb[4];
      unpack4(*reinterpret_cast<const uint32_t*>(pd + (8 * ks + tq) * PP), ra);
      unpack4(*reinterpret_cast<const uint32_t*>(pd + (8 * ks + tq + 4) * PP), rb);
      const uint32_t f[2][4] = {{ra[0], ra[1], rb[0], rb[1]},
                                {ra[2], ra[3], rb[2], rb[3]}};
      // B fragments: x rows 8 mt + g, k 2tq.. and 2tq + 8.. of this step
      uint32_t b0[MT][NP], b1[MT][NP];
      if constexpr (NP == 1) {
#pragma unroll
        for (int mp = 0; mp < (MT + 1) / 2; ++mp) {
          uint32_t bx[4];
          ldsm_x4(bx, xd + (16 * mp + (mat >> 1) * 8 + (lane & 7)) * XP +
                          16 * ks + (mat & 1) * 8);
          b0[2 * mp][0] = bx[0];
          b1[2 * mp][0] = bx[1];
          if (2 * mp + 1 < MT) {
            b0[2 * mp + 1][0] = bx[2];
            b1[2 * mp + 1][0] = bx[3];
          }
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* xr = xd + (8 * mt + g) * XP + 16 * ks + 2 * tq;
          const float2 u = *reinterpret_cast<const float2*>(xr);
          const float2 v = *reinterpret_cast<const float2*>(xr + 8);
          pieces2<NP>(u.x, u.y, b0[mt]);
          pieces2<NP>(v.x, v.y, b1[mt]);
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int pc = NP - 1; pc >= 0; --pc)
            mma(p[t][mt], f[t], b0[mt][pc], b1[mt][pc]);
      if (++step == steps) {                   // the group ends: scale it in
        step = 0;
        const uint2 sw = *reinterpret_cast<const uint2*>(
            sd + (k0 / group - g0) * BN * 2);
        const float s[4] = {bf16_lo(sw.x), bf16_hi(sw.x), bf16_lo(sw.y),
                            bf16_hi(sw.y)};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[t][mt][e] = fmaf(s[2 * t + (e >> 1)], p[t][mt][e], acc[t][mt][e]);
              p[t][mt][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();

  // C element e of tile t, m8 tile mt: x row 8 mt + 2 tq + (e & 1), column
  // 4g + 2t + (e >> 1)
  float* d = dst + (long long)split * M * N * (n_split > 1);
  const int ncol = n0 + col;
  const bool vec = (N & 3) == 0 && ncol + 3 < N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int el = 0; el < 2; ++el) {
      const int m = m0 + 8 * mt + 2 * tq + el;
      if (m >= M) continue;
      const float v[4] = {acc[0][mt][el], acc[0][mt][2 + el], acc[1][mt][el],
                          acc[1][mt][2 + el]};
      float* o = d + (long long)m * N + ncol;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ncol + q < N) o[q] = v[q];
      }
    }
}

// out = the splits' partials added in split order
__global__ void __launch_bounds__(256)
q4_combine(const float* __restrict__ ws, float* __restrict__ out, long long mn,
           int n_split) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += (long long)gridDim.x * 256) {
    float s = ws[i];
    for (int k = 1; k < n_split; ++k) s += ws[k * mn + i];
    out[i] = s;
  }
}

template <typename T, int MT, bool kAligned>
int launch(const void* x, const uint8_t* pp, const __nv_bfloat16* sp, float* d,
           int M, int N, int K, int group, int n_split, cudaStream_t s) {
  constexpr int kBytes = Cfg<T, MT>::kBytes;
  static_assert(kBytes <= 48 * 1024, "the ring needs no shared-memory opt-in");
  const dim3 grid((N + BN - 1) / BN, (M + 8 * MT - 1) / (8 * MT), n_split);
  q4_gemm<T, MT, kAligned><<<grid, kThreads, kBytes, s>>>(
      static_cast<const T*>(x), pp, sp, d, M, N, K, group, n_split);
  return int(cudaGetLastError());
}

// decode: 8 rows (M <= 8) or 16 rows a CTA; tile: 64 rows (bf16 x only)
template <typename T, bool kAligned>
int route(int path, const void* x, const uint8_t* pp, const __nv_bfloat16* sp,
          float* d, int M, int N, int K, int group, int n_split,
          cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (path == kTile)
      return launch<T, 8, kAligned>(x, pp, sp, d, M, N, K, group, n_split, s);
  }
  if (M <= 8)
    return launch<T, 1, kAligned>(x, pp, sp, d, M, N, K, group, n_split, s);
  return launch<T, 2, kAligned>(x, pp, sp, d, M, N, K, group, n_split, s);
}

}  // namespace

extern "C" {

const char* q4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B3. x (M, K) contiguous, x_dtype 0 = f32, 1 = bf16; packed (K/2, N) int8
// and scale (K/group, N) bf16 contiguous; out (M, N) f32. The plan comes
// from the caller (kernels/q4_matmul.py q4_plan): path 0 = decode, 1 = tile
// (bf16 x only); n_split CTAs along K, and with n_split > 1 ws holds
// (n_split, M, N) f32 partials. aligned: x, packed and scale 16-byte aligned
// and N % 16 == 0. The caller checks shapes: M >= 1, group % 16 == 0,
// K % group == 0, 1 <= n_split <= K / group. Launches on `stream` (one or
// two kernels); returns the first CUDA error code.
int q4_matmul(const void* x, const void* packed, const void* scale, void* out,
              void* ws, int x_dtype, int M, int N, int K, int group, int path,
              int n_split, int aligned, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || group < 16 || group % 16 || K % group ||
      n_split < 1 || n_split > K / group || (n_split > 1 && !ws) ||
      (path == kTile && x_dtype != kBF16) || (path != kTile && path != kDecode))
    return int(cudaErrorInvalidValue);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scale);
  float* d = static_cast<float*>(n_split > 1 ? ws : out);
  int code;
  if (x_dtype == kBF16)
    code = aligned ? route<__nv_bfloat16, true>(path, x, pp, sp, d, M, N, K, group, n_split, s)
                   : route<__nv_bfloat16, false>(path, x, pp, sp, d, M, N, K, group, n_split, s);
  else if (x_dtype == kF32)
    code = aligned ? route<float, true>(path, x, pp, sp, d, M, N, K, group, n_split, s)
                   : route<float, false>(path, x, pp, sp, d, M, N, K, group, n_split, s);
  else
    return int(cudaErrorInvalidValue);
  if (code || n_split == 1) return code;
  const long long mn = (long long)M * N;
  const long long want = (mn + 255) / 256;
  const int blocks = int(want < 132 * 8 ? want : 132 * 8);
  q4_combine<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                    static_cast<float*>(out), mn, n_split);
  return int(cudaGetLastError());
}

}  // extern "C"
