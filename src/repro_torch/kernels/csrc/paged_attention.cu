// Paged attention for Hopper (sm_90a): decode/verify over float pages (B1)
// through a block-table-addressed page pool.
//
// Replaces the Pallas TPU kernel
//   B1 src/repro/kernels/paged_decode.py  paged_verify / paged_decode
// (B2 paged_prefill and B4 paged_verify_quant run on the tensor-core tile
// kernels of paged_tiles.cu; nothing of theirs reaches this file.)
//
// What it computes: GQA flash attention of R = T*n_rep query rows of one
// (sequence b, kv head h) against that sequence's pages, routed through
// table[b, :]. Row (t, rep) sits at absolute position kv_len[b] - T + t and
// sees positions <= its own (and > own - window when a window is set).
// Online softmax (m, l, acc) in f32; scores are (q * scale) . k in f32 as in
// the Pallas kernels; a fully masked row returns 0 (l floored at 1e-30).
//
// What bounds it on the H100: bytes. At decode every K/V byte of a live
// page is read once per (b, h) and used by only T*n_rep rows (5 for
// qwen2.5-14b at T = 1), far below the ~295 flop/byte the tensor cores need.
//
// What this design does about it:
//   * the pool is read in its stored (P, bs, h_kv, D) layout through its
//     strides; the Pallas wrapper's transpose to (P, h_kv, bs, D) would copy
//     the whole layer pool every call;
//   * q is read in place as (B, T, H, D): row = t*n_rep + rep indexes it
//     directly, no regrouping copy;
//   * the page walk is bounded per tile by the live range: pages at or past
//     ceil(kv_len/bs) (stale or sink entries) and pages that end before the
//     tile's window are never loaded.
// Simple first, and still so: one CTA per (row tile of <= 64 rows, kv head,
// sequence) walking its pages in series; 4 warps; each page staged as f32
// in shared memory; lane j scores key j with scalar f32 FMAs (half of the
// lanes idle on 16-token pages). B1 keeps this scalar template on purpose:
// its redesign is the split-page decode of paged_tiles.cu's design 2
// applied to float pages, with B5 (flash_decode.cu) in the same PR, so that
// B1's row measures the old design until then.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Geometry {
  int B, T, H, h_kv, D, bs, nb, window;  // window <= 0: none
  int tile_cap;                          // rows staged per CTA (<= kTileRows)
  float scale;                           // 1/sqrt(D), rounded on the host
  long long q_sb, q_st, q_sh;            // q strides (elements); d contiguous
  long long kv_sp, kv_ss, kv_sh;         // pool strides; d contiguous
};

size_t smem_bytes(const Geometry& g) {
  const size_t floats = 2 * size_t(g.tile_cap) * g.D        // q tile, acc
                        + 2 * size_t(g.bs) * (g.D + 1)       // K, V page
                        + 2 * size_t(g.tile_cap)             // m, l
                        + kWarps * 32;                       // p per warp
  return floats * sizeof(float);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                       const KT* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ kv_len, QT* __restrict__ out,
                       Geometry g) {
  extern __shared__ float smem[];
  const int D = g.D, bs = g.bs, ldk = g.D + 1;
  const int n_rep = g.H / g.h_kv;
  const int rows = g.T * n_rep;
  const int r0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile_rows = min(kTileRows, rows - r0);
  float* qs = smem;                          // [tile_cap][D], pre-scaled
  float* acc = qs + g.tile_cap * D;          // [tile_cap][D]
  float* kt = acc + g.tile_cap * D;          // [bs][D+1]
  float* vt = kt + bs * ldk;                 // [bs][D+1]
  float* m_s = vt + bs * ldk;                // [tile_cap]
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

  // live page range of this tile: nothing at or past the newest row's
  // position (this bounds the walk by ceil(kv_len/bs) too), nothing that
  // ends before the oldest row's window
  const int qpos_lo = len - g.T + r0 / n_rep;
  const int qpos_hi = len - g.T + (r0 + tile_rows - 1) / n_rep;
  const int p_end = qpos_hi < 0 ? 0 : min(g.nb, qpos_hi / bs + 1);
  const int p_begin = g.window > 0 ? max(0, qpos_lo - g.window + 1) / bs : 0;

  for (int jp = p_begin; jp < p_end; ++jp) {
    __syncthreads();                         // previous page fully consumed
    const long long pid = table[b * g.nb + jp];
    const KT* kpage = kp + pid * g.kv_sp + h * g.kv_sh;
    const KT* vpage = vp + pid * g.kv_sp + h * g.kv_sh;
    for (int i = tid; i < bs * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      kt[j * ldk + d] = to_f32(kpage[j * g.kv_ss + d]);
      vt[j * ldk + d] = to_f32(vpage[j * g.kv_ss + d]);
    }
    __syncthreads();

    for (int r = warp; r < tile_rows; r += kWarps) {
      const int qpos = len - g.T + (r0 + r) / n_rep;
      const float* qrow = qs + r * D;
      float* arow = acc + r * D;
      for (int c0 = 0; c0 < bs; c0 += 32) {
        const int j = c0 + lane;
        const int pos = jp * bs + j;
        const bool live = j < bs && pos <= qpos &&
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
        const int n = min(32, bs - c0);
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
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* kv_len, void* out, const Geometry& g,
           cudaStream_t stream) {
  const int rows = g.T * (g.H / g.h_kv);
  const size_t smem = smem_bytes(g);
  auto kern = paged_attention_kernel<QT, KT>;
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
      static_cast<const KT*>(v), static_cast<const int*>(table),
      static_cast<const int*>(kv_len), static_cast<QT*>(out), g);
  return int(cudaGetLastError());
}

template <typename QT>
int dispatch_float_kv(int kv_dtype, const void* q, const void* k,
                      const void* v, const void* table, const void* kv_len,
                      void* out, const Geometry& g, cudaStream_t s) {
  if (kv_dtype == kF32)
    return launch<QT, float>(q, k, v, table, kv_len, out, g, s);
  if (kv_dtype == kBF16)
    return launch<QT, __nv_bfloat16>(q, k, v, table, kv_len, out, g, s);
  return int(cudaErrorInvalidValue);
}

int float_pages(int q_dtype, int kv_dtype, const void* q, const void* k,
                const void* v, const void* table, const void* kv_len,
                void* out, const Geometry& g, cudaStream_t s) {
  if (q_dtype == kF32)
    return dispatch_float_kv<float>(kv_dtype, q, k, v, table, kv_len, out, g,
                                    s);
  if (q_dtype == kBF16)
    return dispatch_float_kv<__nv_bfloat16>(kv_dtype, q, k, v, table, kv_len,
                                            out, g, s);
  return int(cudaErrorInvalidValue);
}

Geometry make_geometry(int B, int T, int H, int h_kv, int D, int bs, int nb,
                       int window, float scale, long long q_sb,
                       long long q_st, long long q_sh, long long kv_sp,
                       long long kv_ss, long long kv_sh) {
  Geometry g;
  g.B = B; g.T = T; g.H = H; g.h_kv = h_kv; g.D = D; g.bs = bs; g.nb = nb;
  g.window = window;
  const int rows = T * (H / h_kv);
  g.tile_cap = rows < kTileRows ? rows : kTileRows;
  g.scale = scale;
  g.q_sb = q_sb; g.q_st = q_st; g.q_sh = q_sh;
  g.kv_sp = kv_sp; g.kv_ss = kv_ss; g.kv_sh = kv_sh;
  return g;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
long long paged_attention_smem_bytes(int T, int H, int h_kv, int D, int bs) {
  Geometry g = make_geometry(1, T, H, h_kv, D, bs, 1, 0, 1.f, 0, 0, 0, 0, 0,
                             0);
  return (long long)smem_bytes(g);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1: T query rows per sequence against float pages (T = 1 is decode).
int paged_verify(const void* q, const void* k, const void* v,
                 const void* table, const void* kv_len, void* out,
                 int q_dtype, int kv_dtype, int B, int T, int H, int h_kv,
                 int D, int bs, int nb, int window, float scale,
                 long long q_sb, long long q_st, long long q_sh,
                 long long kv_sp, long long kv_ss, long long kv_sh,
                 void* stream) {
  const Geometry g = make_geometry(B, T, H, h_kv, D, bs, nb, window, scale,
                                   q_sb, q_st, q_sh, kv_sp, kv_ss, kv_sh);
  return float_pages(q_dtype, kv_dtype, q, k, v, table, kv_len, out, g,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
