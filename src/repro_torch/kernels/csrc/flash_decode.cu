// Decode/verify attention over a contiguous KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   B5 src/repro/kernels/flash_decode.py  flash_verify / flash_decode
//
// What it computes: GQA flash attention of R = T*n_rep query rows of one
// (sequence b, kv head h) against that sequence's cache k/v[b, :, h, :].
// Row r = t*n_rep + rep reads query head h*n_rep + rep (the grouping of the
// JAX package's _repeat_kv), sits at absolute position kv_len[b] - T + t and
// sees positions <= its own (and > own - window when a window is set), among
// the S positions the cache holds. Online softmax (m, l, acc) in f32; scores
// are (q * scale) . k in f32 as in the Pallas kernel; a fully masked row
// returns 0 (l floored at 1e-30). This is B1's math (paged_attention.cu)
// with the page table taken away: key j lives at row j of the cache.
//
// What bounds it on the H100: bytes. Every visible K/V byte of (b, h) is
// read once and used by only T*n_rep rows (5 for qwen1.5-32b's verify at
// T = 5, 1 for its draft's decode), far below the ~295 flop/byte the tensor
// cores need.
//
// What this design does about it:
//   * k/v are read in the port's stored cache layout (B, S_max, h_kv, D)
//     through their strides, in place: the Pallas wrapper's transpose to
//     (B, h_kv, S, D) would copy a layer's whole cache on every call; q is
//     read in place as (B, T, H, D);
//   * the key walk is bounded per tile by the live range: nothing at or
//     past min(S, the newest row's position + 1) -- kv_len may exceed S
//     where a verify pass near the end of the cache clamped its writes --
//     and nothing that ends before the oldest row's window;
//   * any S: the last block of keys is ragged (the Pallas kernel needs
//     S % min(512, S) == 0).
// Deterministic per row: each row is one warp's, its keys are scored 32 at
// a time in blocks aligned to absolute positions, so a row's sums run in an
// order that depends neither on T, n_rep nor B. A block that a row cannot
// see leaves (m, l, acc) exactly as they were, so where the walk starts
// does not matter either: a verify pass's row t computes what a single
// decode step at that position computes, to the bit.
// Simple first: one CTA per (row tile of <= 64 rows, kv head, sequence);
// 4 warps; 64 keys staged as f32 in shared memory at a time; lane j scores
// key j. Not yet done (later work): splitting S across CTAs (the decode
// grid is B*h_kv CTAs, below the 132 SMs), cp.async/TMA pipelines, wider
// loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;
constexpr int kKeys = 64;                    // keys staged per block
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Geometry {
  int B, T, H, h_kv, D, S, window;   // window <= 0: none
  int tile_cap;                      // rows staged per CTA (<= kTileRows)
  float scale;                       // 1/sqrt(D), rounded on the host
  long long q_sb, q_st, q_sh;        // q strides (elements); d contiguous
  long long kv_sb, kv_ss, kv_sh;     // k/v strides; d contiguous
};

size_t smem_bytes(const Geometry& g) {
  const size_t floats = 2 * size_t(g.tile_cap) * g.D       // q tile, acc
                        + 2 * size_t(kKeys) * (g.D + 1)     // K, V block
                        + 2 * size_t(g.tile_cap)            // m, l
                        + kWarps * 32;                      // p per warp
  return floats * sizeof(float);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
flash_verify_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ kv_len,
                    QT* __restrict__ out, Geometry g) {
  extern __shared__ float smem[];
  const int D = g.D, ldk = g.D + 1;
  const int n_rep = g.H / g.h_kv;
  const int rows = g.T * n_rep;
  const int r0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile_rows = min(kTileRows, rows - r0);
  float* qs = smem;                          // [tile_cap][D], pre-scaled
  float* acc = qs + g.tile_cap * D;          // [tile_cap][D]
  float* kt = acc + g.tile_cap * D;          // [kKeys][D+1]
  float* vt = kt + kKeys * ldk;              // [kKeys][D+1]
  float* m_s = vt + kKeys * ldk;             // [tile_cap]
  float* l_s = m_s + g.tile_cap;             // [tile_cap]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pw = l_s + g.tile_cap + warp * 32;  // this warp's probabilities

  const int len = kv_len[b];
  for (int i = tid; i < tile_rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r, t = row / n_rep;
    const int head = h * n_rep + (row - t * n_rep);
    qs[i] = to_f32(q[b * g.q_sb + t * g.q_st + head * g.q_sh + d]) * g.scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < tile_rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // live key range of this tile: nothing past the cache, nothing at or
  // past the newest row's position, nothing that ends before the oldest
  // row's window; blocks start at multiples of kKeys
  const int qpos_lo = len - g.T + r0 / n_rep;
  const int qpos_hi = len - g.T + (r0 + tile_rows - 1) / n_rep;
  const int key_end = qpos_hi < 0 ? 0 : min(g.S, qpos_hi + 1);
  const int key_begin =
      g.window > 0 ? max(0, qpos_lo - g.window + 1) / kKeys * kKeys : 0;
  const KT* kb = k + b * g.kv_sb + h * g.kv_sh;
  const KT* vb = v + b * g.kv_sb + h * g.kv_sh;

  for (int j0 = key_begin; j0 < key_end; j0 += kKeys) {
    const int nk = min(kKeys, key_end - j0);
    __syncthreads();                         // previous block consumed
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const long long off = (long long)(j0 + j) * g.kv_ss + d;
      kt[j * ldk + d] = to_f32(kb[off]);
      vt[j * ldk + d] = to_f32(vb[off]);
    }
    __syncthreads();

    for (int r = warp; r < tile_rows; r += kWarps) {
      const int qpos = len - g.T + (r0 + r) / n_rep;
      const float* qrow = qs + r * D;
      float* arow = acc + r * D;
      for (int c0 = 0; c0 < nk; c0 += 32) {
        const int j = c0 + lane;
        const int pos = j0 + j;
        const bool live = j < nk && pos <= qpos &&
                          (g.window <= 0 || pos > qpos - g.window);
        float s = -INFINITY;
        if (live) {
          const float* krow = kt + j * ldk;
          float a = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(qrow[d], krow[d], a);
          s = a;
        }
        float m_cur = s;
        for (int o = 16; o > 0; o >>= 1)
          m_cur = fmaxf(m_cur, __shfl_xor_sync(kFull, m_cur, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, m_cur);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float p = live ? expf(s - m_safe) : 0.f;
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
        float psum = p;
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(kFull, psum, o);
        pw[lane] = p;
        __syncwarp();
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * corr + psum;
        }
        const int n = min(32, nk - c0);
        for (int d = lane; d < D; d += 32) {
          float a = arow[d] * corr;
          for (int jj = 0; jj < n; ++jj)
            a = fmaf(pw[jj], vt[(c0 + jj) * ldk + d], a);
          arow[d] = a;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < tile_rows; r += kWarps) {
    const int row = r0 + r, t = row / n_rep;
    const int head = h * n_rep + (row - t * n_rep);
    const float l = fmaxf(l_s[r], 1e-30f);
    QT* orow = out + ((long long)(b * g.T + t) * g.H + head) * D;
    for (int d = lane; d < D; d += 32) store_as(orow + d, acc[r * D + d] / l);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, const Geometry& g, cudaStream_t stream) {
  const int rows = g.T * (g.H / g.h_kv);
  const size_t smem = smem_bytes(g);
  auto kern = flash_verify_kernel<QT, KT>;
  static size_t smem_set = 48 * 1024;        // the default opt-in ceiling
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    smem_set = smem;
  }
  const dim3 grid((rows + kTileRows - 1) / kTileRows, g.h_kv, g.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(kv_len),
      static_cast<QT*>(out), g);
  return int(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                const void* kv_len, void* out, const Geometry& g,
                cudaStream_t s) {
  if (kv_dtype == kF32)
    return launch<QT, float>(q, k, v, kv_len, out, g, s);
  if (kv_dtype == kBF16)
    return launch<QT, __nv_bfloat16>(q, k, v, kv_len, out, g, s);
  return int(cudaErrorInvalidValue);
}

Geometry make_geometry(int B, int T, int H, int h_kv, int D, int S,
                       int window, float scale) {
  Geometry g;
  g.B = B; g.T = T; g.H = H; g.h_kv = h_kv; g.D = D; g.S = S;
  g.window = window;
  const int rows = T * (H / h_kv);
  g.tile_cap = rows < kTileRows ? rows : kTileRows;
  g.scale = scale;
  g.q_sb = g.q_st = g.q_sh = 0;
  g.kv_sb = g.kv_ss = g.kv_sh = 0;
  return g;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
long long flash_decode_smem_bytes(int T, int H, int h_kv, int D) {
  const Geometry g = make_geometry(1, T, H, h_kv, D, 1, 0, 1.f);
  return (long long)smem_bytes(g);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B5: T query rows per sequence against a contiguous cache (T = 1 is
// decode). q and k/v each f32 or bf16; the output is in q's dtype.
int flash_verify(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, int q_dtype, int kv_dtype,
                 int B, int T, int H, int h_kv, int D, int S, int window,
                 float scale, long long q_sb, long long q_st, long long q_sh,
                 long long kv_sb, long long kv_ss, long long kv_sh,
                 void* stream) {
  Geometry g = make_geometry(B, T, H, h_kv, D, S, window, scale);
  g.q_sb = q_sb; g.q_st = q_st; g.q_sh = q_sh;
  g.kv_sb = kv_sb; g.kv_ss = kv_ss; g.kv_sh = kv_sh;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_kv<float>(kv_dtype, q, k, v, kv_len, out, g, s);
  if (q_dtype == kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, kv_len, out, g, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
