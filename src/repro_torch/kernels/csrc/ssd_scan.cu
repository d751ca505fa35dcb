// Mamba-2 SSD chunked scan from the zero state for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   B6 src/repro/kernels/ssd_scan.py  ssd_scan
//
// What it computes: for one (sequence b, head) the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t . h_t,
// h_{-1} = 0, in the chunked (state-space-duality) form: per chunk of
// `chunk` positions, with cum = the running sum of dt A inside the chunk,
//   y_t  = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
//        + exp(cum_t) C_t . h_prev
//   h    = exp(cum_end) h_prev + sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
// and writes y (B, S, nh, P) and the final state h (B, nh, P, N) in x's
// dtype. All products and sums are in f32, in a fixed order. Positions
// past S are the zero padding of the reference (dt = 0, x = B = C = 0):
// the last chunk is ragged and stops at S, which is the same function.
// dt >= 0 and A <= 0, so cum never increases; it is summed in position
// order, so cum_t - cum_s <= 0 for s <= t exactly and every exponent the
// kernel takes is <= 0 (the masked s > t differences are never formed:
// they overflow, and inf * 0 is NaN).
//
// What bounds it on the H100: at mamba2-780m's prefill shapes (P 64, N
// 128, chunk 128) the work is about 170 flop a byte moved, under the
// tensor cores' ~295, so the card's bound is bytes. This kernel does its
// products on the f32 SIMT units (67 TFLOP/s, not 989) on 48 CTAs (one a
// (b, head)) of 132 SMs, with the chunks in series: operations bound it.
//
// What this design does about it: little yet -- it is the simple kernel.
// x, B and C are read in place through their strides (in the model they
// are views of one conv output, row stride di + 2N): the Pallas wrapper's
// transpose of x to (B, nh, S, P) is a copy this kernel does not make.
// A chunk's B and C are staged once in shared memory as f32 with rows
// padded to N + 1 (no bank conflicts), dt x beside them; the (P, N)
// state stays in shared memory across the chunks. C B^T is formed 32
// rows at a time, only where s <= t.
// Not yet done (later work): chunk states in parallel across CTAs and a
// scan over chunks (fills the card at B = 1), C B^T shared by the heads of
// a sequence, tensor cores (mma/wgmma) for the three chunk products,
// cp.async/TMA staging.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowTile = 32;                 // rows of C B^T formed at once

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Geometry {
  int B, S, nh, P, N, chunk;
  long long x_sb, x_ss, x_sh;                // x strides (elements); p contiguous
  long long dt_sb, dt_ss, dt_sh;             // dt strides
  long long b_sb, b_ss;                      // B strides; n contiguous
  long long c_sb, c_ss;                      // C strides; n contiguous
};

size_t smem_bytes(int P, int N, int chunk) {
  const size_t ldn = size_t(N) + 1, ck = size_t(chunk);
  const size_t floats = 2 * ck * ldn         // B, C chunk
                        + ck * P             // dt x
                        + size_t(P) * ldn    // state
                        + 3 * ck             // dt, cum, decay to the end
                        + kRowTile * ck;     // a row tile of C B^T (masked)
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                T* __restrict__ h_out, Geometry g) {
  extern __shared__ float smem[];
  const int P = g.P, N = g.N, ck = g.chunk, ldn = g.N + 1;
  const int head = blockIdx.x, b = blockIdx.y;
  float* bs = smem;                          // [ck][ldn]
  float* cs = bs + ck * ldn;                 // [ck][ldn]
  float* xdt = cs + ck * ldn;                // [ck][P]   dt_s x_s
  float* hs = xdt + ck * P;                  // [P][ldn]  the state
  float* dts = hs + P * ldn;                 // [ck]
  float* cum = dts + ck;                     // [ck]
  float* dec = cum + ck;                     // [ck]      exp(cum_end - cum_s)
  float* sc = dec + ck;                      // [kRowTile][ck]
  const int tid = threadIdx.x;
  const float a = A[head];

  const T* xb = x + b * g.x_sb + head * g.x_sh;
  const float* dtb = dt + b * g.dt_sb + head * g.dt_sh;
  const T* bb = Bm + b * g.b_sb;
  const T* cb = Cm + b * g.c_sb;
  T* yb = y + ((long long)b * g.S * g.nh + head) * P;   // + t * nh * P + p
  const long long y_st = (long long)g.nh * P;

  for (int i = tid; i < P * ldn; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < g.S; c0 += ck) {
    const int n = min(ck, g.S - c0);
    __syncthreads();                         // the previous chunk is consumed
    for (int i = tid; i < n; i += kThreads)
      dts[i] = dtb[(long long)(c0 + i) * g.dt_ss];
    for (int i = tid; i < n * N; i += kThreads) {
      const int t = i / N, k = i - t * N;
      bs[t * ldn + k] = to_f32(bb[(long long)(c0 + t) * g.b_ss + k]);
      cs[t * ldn + k] = to_f32(cb[(long long)(c0 + t) * g.c_ss + k]);
    }
    for (int i = tid; i < n * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      xdt[i] = to_f32(xb[(long long)(c0 + t) * g.x_ss + p]);
    }
    __syncthreads();
    if (tid == 0) {                          // cum in position order
      float run = 0.f;
      for (int i = 0; i < n; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    } else if (tid >= 32) {                  // meanwhile: dt_s x_s
      for (int i = tid - 32; i < n * P; i += kThreads - 32)
        xdt[i] *= dts[i / P];
    }
    __syncthreads();
    const float total = cum[n - 1];
    for (int i = tid; i < n; i += kThreads) dec[i] = expf(total - cum[i]);

    // y, kRowTile rows at a time
    for (int t0 = 0; t0 < n; t0 += kRowTile) {
      const int rows = min(kRowTile, n - t0);
      const int s_end = t0 + rows;
      for (int i = tid; i < rows * s_end; i += kThreads) {
        const int r = i / s_end, s = i - r * s_end;
        const int t = t0 + r;
        float v = 0.f;
        if (s <= t) {
          const float* crow = cs + t * ldn;
          const float* brow = bs + s * ldn;
          float acc = 0.f;
          for (int k = 0; k < N; ++k) acc = fmaf(crow[k], brow[k], acc);
          v = acc * expf(cum[t] - cum[s]);
        }
        sc[r * ck + s] = v;
      }
      __syncthreads();
      for (int i = tid; i < rows * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        const int t = t0 + r;
        const float* srow = sc + r * ck;
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) acc = fmaf(srow[s], xdt[s * P + p], acc);
        if (c0 > 0) {                        // the state is 0 before chunk 1
          const float* crow = cs + t * ldn;
          const float* hrow = hs + p * ldn;
          float inter = 0.f;
          for (int k = 0; k < N; ++k) inter = fmaf(crow[k], hrow[k], inter);
          acc = fmaf(expf(cum[t]), inter, acc);
        }
        store_as(yb + (long long)(c0 + t) * y_st + p, acc);
      }
      __syncthreads();                       // sc and hs reads done
    }

    // h = exp(total) h + sum_s exp(total - cum_s) dt_s x_s B_s^T
    for (int i = tid; i < n * P; i += kThreads) xdt[i] *= dec[i / P];
    __syncthreads();
    const float et = expf(total);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, k = i - p * N;
      float acc = 0.f;
      for (int s = 0; s < n; ++s) acc = fmaf(xdt[s * P + p], bs[s * ldn + k], acc);
      hs[p * ldn + k] = fmaf(hs[p * ldn + k], et, acc);
    }
  }
  __syncthreads();
  T* hb = h_out + ((long long)b * g.nh + head) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, k = i - p * N;
    store_as(hb + i, hs[p * ldn + k]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h, const Geometry& g,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(g.P, g.N, g.chunk);
  auto kern = ssd_scan_kernel<T>;
  static size_t smem_set = 48 * 1024;        // the default opt-in ceiling
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    smem_set = smem;
  }
  const dim3 grid(g.nh, g.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(h), g);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
long long ssd_scan_smem_bytes(int P, int N, int chunk) {
  return (long long)smem_bytes(P, N, chunk);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B6: x, B and C in one dtype (f32 or bf16), dt and A f32; y and h out
// in x's dtype, contiguous.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* h, int x_dtype, int B, int S,
             int nh, int P, int N, int chunk, long long x_sb, long long x_ss,
             long long x_sh, long long dt_sb, long long dt_ss,
             long long dt_sh, long long b_sb, long long b_ss,
             long long c_sb, long long c_ss, void* stream) {
  Geometry g;
  g.B = B; g.S = S; g.nh = nh; g.P = P; g.N = N; g.chunk = chunk;
  g.x_sb = x_sb; g.x_ss = x_ss; g.x_sh = x_sh;
  g.dt_sb = dt_sb; g.dt_ss = dt_ss; g.dt_sh = dt_sh;
  g.b_sb = b_sb; g.b_ss = b_ss; g.c_sb = c_sb; g.c_ss = c_ss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch<float>(x, dt, A, Bm, Cm, y, h, g, s);
  if (x_dtype == kBF16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, g, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
