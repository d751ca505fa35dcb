// W4A16 grouped matmul for Hopper (sm_90a): out (M, N) f32 =
//   x (M, K) f32|bf16  @  dequant(packed (K/2, N) int8, scale (K/g, N) bf16)
//
// Replaces the Pallas TPU kernel
//   B3 src/repro/kernels/q4_matmul.py  q4_matmul  (pl.pallas_call at :81)
// whose oracle is src/repro/kernels/ref.py q4_matmul_ref.
//
// What it computes: packed byte (r, n) holds weight row 2r in its low nibble
// and row 2r+1 in its high nibble, 4-bit two's complement. Weight (k, n) is
// that sign-extended nibble times the f32 value of scale[k / g, n]; the
// product with x is summed over k in f32. The Pallas kernel dequantizes a
// (bk, bn) tile into VMEM and carries the f32 output tile across its
// sequential k grid axis; blocks on the card run in no order, so here each
// CTA owns its output tile and loops over all of K itself.
//
// What bounds it on the H100: bytes at decode, operations at prefill. At
// M = B*T <= 16 every packed byte feeds at most 32 multiply-adds (two
// weights, 16 rows), far under the ~295 flop/byte ridge: the least time is
// (K/2*N + 2*K/g*N + x + out bytes) / 3.35 TB/s, ~11.4 us for a qwen2.5-14b
// (5120, 13824) projection at M = 8. At prefill (M = the prompt length,
// hundreds of rows) the 2*M*K*N multiply-adds set the bound.
//
// What this design does about it:
//   * only the packed int4 bytes and the bf16 scales cross HBM: nibbles are
//     unpacked and sign-extended in registers and each weight is scaled in
//     f32 just before its multiply-add; no dequantized weight is written;
//   * reads of packed and scale are coalesced along N (the (K/2, N) layout
//     is row-major, N contiguous): lane j of a warp reads columns 2j, 2j+1;
//   * decode (M <= 16, q4_gemv): one CTA covers all M rows of a 64-column
//     slab, so each packed byte is read from HBM exactly once; its 8 warps
//     split K by packed row (warp w takes rows w, w+8, ...) and their
//     partial sums are added in a fixed order through shared memory, so the
//     result does not depend on scheduling; x is staged per K chunk in
//     shared memory as f32 and read as a warp-wide broadcast;
//   * prefill (M > 16, q4_tiled): a plain SIMT tile of 64 x 128 outputs per
//     CTA, 4 x 8 per thread, the packed tile dequantized into shared memory
//     (f32) once per 32-row K step and reused by all 64 rows;
//   * ragged M, N and K edges are masked, so any M works.
// Simple first. For the redesign, not done here:
//   * with bf16 x, x * q (q in [-8, 7]) is exact in bf16 MMA operands, so
//     wgmma / mma.sync per group with the scale applied to the f32 group
//     partial keeps the f32 result and moves prefill onto the tensor cores;
//   * at decode, split K across CTAs (a second pass or a fixed-order
//     combine): N = 1024 (wk, wv) gives this kernel only 16 CTAs for the
//     132 SMs, N = 5120 gives 80.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// sign-extended low / high nibble of a packed byte
__device__ __forceinline__ float lo_nib(int p) {
  return float(int(unsigned(p) << 28) >> 28);
}
__device__ __forceinline__ float hi_nib(int p) {
  return float(int(unsigned(p) << 24) >> 28);
}

__device__ __forceinline__ float scale_at(const __nv_bfloat16* __restrict__ scale,
                                          int k, int n, int N, int group) {
  return __bfloat162float(scale[(long long)(k / group) * N + n]);
}

// ---------------------------------------------------------------- decode --

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 64;     // two columns a lane
constexpr int kGemvChunk = 512;   // k values of x staged per step

// MT: rows of x per CTA (the smallest power of two >= M, at most 16).
template <typename T, int MT>
__global__ void __launch_bounds__(kGemvThreads)
q4_gemv(const T* __restrict__ x, const int8_t* __restrict__ packed,
        const __nv_bfloat16* __restrict__ scale, float* __restrict__ out,
        int M, int N, int K, int group) {
  // x chunk [MT][kGemvChunk] during the K loop, then the per-warp partials
  // [kGemvWarps][MT][kGemvCols]: the same MT * 512 floats
  __shared__ __align__(16) float smem[MT * kGemvChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kGemvCols + 2 * lane;
  const bool c0 = n0 < N, c1 = n0 + 1 < N;

  float acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.f;

  for (int kc = 0; kc < K; kc += kGemvChunk) {
    const int kn = min(kGemvChunk, K - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kGemvChunk; i += kGemvThreads) {
      const int m = i / kGemvChunk, kk = i % kGemvChunk;
      smem[i] = (m < M && kk < kn) ? to_f32(x[(long long)m * K + kc + kk]) : 0.f;
    }
    __syncthreads();
    const int rows = kn / 2;   // K is even, so every chunk holds whole rows
#pragma unroll 4
    for (int rr = warp; rr < rows; rr += kGemvWarps) {
      const int k = kc + 2 * rr;
      const long long off = (long long)(k / 2) * N + n0;
      const int p0 = c0 ? packed[off] : 0;
      const int p1 = c1 ? packed[off + 1] : 0;
      const float sa0 = c0 ? scale_at(scale, k, n0, N, group) : 0.f;
      const float sa1 = c1 ? scale_at(scale, k, n0 + 1, N, group) : 0.f;
      float sb0 = sa0, sb1 = sa1;
      if ((k + 1) / group != k / group) {   // a group edge between the rows
        sb0 = c0 ? scale_at(scale, k + 1, n0, N, group) : 0.f;
        sb1 = c1 ? scale_at(scale, k + 1, n0 + 1, N, group) : 0.f;
      }
      const float wa0 = lo_nib(p0) * sa0, wb0 = hi_nib(p0) * sb0;
      const float wa1 = lo_nib(p1) * sa1, wb1 = hi_nib(p1) * sb1;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float2 xv = *reinterpret_cast<const float2*>(
            &smem[m * kGemvChunk + 2 * rr]);
        acc[m][0] = fmaf(xv.y, wb0, fmaf(xv.x, wa0, acc[m][0]));
        acc[m][1] = fmaf(xv.y, wb1, fmaf(xv.x, wa1, acc[m][1]));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    smem[(warp * MT + m) * kGemvCols + 2 * lane] = acc[m][0];
    smem[(warp * MT + m) * kGemvCols + 2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols, c = i % kGemvCols;
    const int n = blockIdx.x * kGemvCols + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int w = 0; w < kGemvWarps; ++w) s += smem[(w * MT + m) * kGemvCols + c];
    out[(long long)m * N + n] = s;
  }
}

// --------------------------------------------------------------- prefill --

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kTiledThreads = 256;   // 16 x 16, each 4 rows x 8 columns

template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
q4_tiled(const T* __restrict__ x, const int8_t* __restrict__ packed,
         const __nv_bfloat16* __restrict__ scale, float* __restrict__ out,
         int M, int N, int K, int group) {
  __shared__ float xs[kBK][kBM + 1];   // x tile, transposed (+1: no bank
                                       // conflicts on the transposing store)
  __shared__ float ws[kBK][kBN];   // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBM * kBK; i += kTiledThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
    for (int i = tid; i < (kBK / 2) * kBN; i += kTiledThreads) {
      const int r = i / kBN, c = i % kBN;
      const int k = k0 + 2 * r, n = n0 + c;
      float wa = 0.f, wb = 0.f;
      if (k < K && n < N) {   // K is even: row k+1 exists with row k
        const int p = packed[(long long)(k / 2) * N + n];
        wa = lo_nib(p) * scale_at(scale, k, n, N, group);
        wb = hi_nib(p) * scale_at(scale, k + 1, n, N, group);
      }
      ws[2 * r][c] = wa;
      ws[2 * r + 1][c] = wb;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* packed, const void* scale, void* out,
           int M, int N, int K, int group, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* pp = static_cast<const int8_t*>(packed);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= 16) {
    const dim3 grid((N + kGemvCols - 1) / kGemvCols);
    if (M == 1)
      q4_gemv<T, 1><<<grid, kGemvThreads, 0, s>>>(xp, pp, sp, op, M, N, K, group);
    else if (M == 2)
      q4_gemv<T, 2><<<grid, kGemvThreads, 0, s>>>(xp, pp, sp, op, M, N, K, group);
    else if (M <= 4)
      q4_gemv<T, 4><<<grid, kGemvThreads, 0, s>>>(xp, pp, sp, op, M, N, K, group);
    else if (M <= 8)
      q4_gemv<T, 8><<<grid, kGemvThreads, 0, s>>>(xp, pp, sp, op, M, N, K, group);
    else
      q4_gemv<T, 16><<<grid, kGemvThreads, 0, s>>>(xp, pp, sp, op, M, N, K, group);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    q4_tiled<T><<<grid, kTiledThreads, 0, s>>>(xp, pp, sp, op, M, N, K, group);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* q4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B3. x (M, K) contiguous, x_dtype 0 = f32, 1 = bf16; packed (K/2, N) int8
// and scale (K/group, N) bf16 contiguous; out (M, N) f32. The caller checks
// shapes: M >= 1, K even, K % group == 0. Launches on ``stream``; returns the
// launch's CUDA error code.
int q4_matmul(const void* x, const void* packed, const void* scale, void* out,
              int x_dtype, int M, int N, int K, int group, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 2 || (K & 1) || group < 1 || K % group)
    return int(cudaErrorInvalidValue);
  if (x_dtype == kF32) return launch<float>(x, packed, scale, out, M, N, K, group, s);
  if (x_dtype == kBF16)
    return launch<__nv_bfloat16>(x, packed, scale, out, M, N, K, group, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
