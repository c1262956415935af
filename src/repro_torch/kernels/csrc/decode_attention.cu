// decode_attention.cu — single-query (decode) GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention.py:71): one new query per sequence
// attends over a (B, S, Hkv, Dh) KV cache, GQA by h // g, masked by
// positions (kv_pos >= 0, causal kv_pos <= q_pos, optional window
// q_pos - kv_pos < window; positions may be out of order, as in a ring
// cache), online softmax in f32 with scale Dh^-0.5, fully masked tiles
// skipped, out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on the H100: memory. At decode every valid K and V row is read once
// and used for 2·g·Dh multiply-adds, about g/2 flops per byte in bf16, far
// below the ~295 the tensor cores need per byte. The floor is the valid
// K/V bytes / 3.35 TB/s.
//
// Design. The TPU grid walks (B, H, kv chunk) in order with the softmax
// state in VMEM. Here B·H is small at decode, so the kv axis is split
// across blocks as well: one block per (kv split, kv head, b), which reads
// each K/V row once for all g query heads that share it. Each of the 4 warps
// takes tiles of 32 rows, one row per lane. A ballot of the row masks skips
// a fully masked tile before any K/V byte is read. A lane computes its
// row's g scores from its K row (16-byte loads) against q kept in shared
// memory; the warp then updates its running max, sum and accumulator per
// head once per tile, and accumulates P·V with lanes split over Dh, so the
// V reads of a row are coalesced. The warps' states merge in shared memory
// into one partial (m, l, acc[Dh]) per (b, head, split), and a second small
// kernel merges the splits by log-sum-exp. The ragged end of S is masked in
// the kernel, never padded. Tensor cores, TMA and wgmma are not used yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;       // kv rows per warp step, one per lane
constexpr int kMaxG = 8;        // query heads per kv head
constexpr int kMaxDh = 128;
constexpr int kMaxDpl = kMaxDh / 32;   // head dims per lane in P·V
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);   // elements per 16-byte load
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) decode_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int S, int H, int Hkv, int Dh, int causal, int window, int split_len,
    float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int g = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  __shared__ float q_s[kMaxG][kMaxDh];
  __shared__ float red_m[kWarps][kMaxG];
  __shared__ float red_l[kWarps][kMaxG];
  __shared__ float red_acc[kWarps][kMaxG][kMaxDh];

  for (int i = threadIdx.x; i < g * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i - j * Dh;
    q_s[j][d] = to_f(q[((size_t)b * H + kvh * g + j) * Dh + d]);
  }
  __syncthreads();

  const int qp = q_pos[b];
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const size_t row_stride = (size_t)Hkv * Dh;
  const T* kbase = k + ((size_t)b * S * Hkv + kvh) * Dh;
  const T* vbase = v + ((size_t)b * S * Hkv + kvh) * Dh;
  constexpr int VN = Vec<T>::N;

  float m[kMaxG], l[kMaxG], acc[kMaxG][kMaxDpl];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) acc[j][i] = 0.f;
  }

  for (int t0 = s_begin + warp * kTile; t0 < s_end; t0 += kWarps * kTile) {
    const int s = t0 + lane;
    bool valid = false;
    if (s < s_end) {
      const int kp = kv_pos[(size_t)b * S + s];
      valid = kp >= 0;
      if (causal) valid = valid && kp <= qp;
      if (window > 0) valid = valid && (qp - kp) < window;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (ballot == 0u) continue;          // fully masked tile: no K/V reads

    float sc[kMaxG];
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) sc[j] = 0.f;
    if (valid) {
      const T* kr = kbase + (size_t)s * row_stride;
      for (int d0 = 0; d0 < Dh; d0 += VN) {
        float kf[VN];
        load16(kr + d0, kf);
#pragma unroll
        for (int j = 0; j < kMaxG; ++j) {
          if (j < g) {
#pragma unroll
            for (int e = 0; e < VN; ++e) sc[j] += q_s[j][d0 + e] * kf[e];
          }
        }
      }
    }

    float p[kMaxG];
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      p[j] = 0.f;
      if (j < g) {
        const float sj = valid ? sc[j] * scale : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(sj));
        const float corr = expf(m[j] - m_new);
        p[j] = valid ? expf(sj - m_new) : 0.f;
        l[j] = l[j] * corr + warp_sum(p[j]);
#pragma unroll
        for (int i = 0; i < kMaxDpl; ++i) acc[j][i] *= corr;
        m[j] = m_new;
      }
    }

    unsigned bits = ballot;
    while (bits) {                       // warp-uniform: rows valid in the tile
      const int r = __ffs(bits) - 1;
      bits &= bits - 1u;
      const T* vr = vbase + (size_t)(t0 + r) * row_stride;
      float vv[kMaxDpl];
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < Dh ? to_f(vr[d]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        if (j < g) {
          const float pr = __shfl_sync(0xffffffffu, p[j], r);
#pragma unroll
          for (int i = 0; i < kMaxDpl; ++i) acc[j][i] += pr * vv[i];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    if (j < g) {
      if (lane == 0) {
        red_m[warp][j] = m[j];
        red_l[warp][j] = l[j];
      }
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) red_acc[warp][j][d] = acc[j][i];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < g * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i - j * Dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w][j]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(red_m[w][j] - M);
      L += red_l[w][j] * c;
      A += red_acc[w][j][d] * c;
    }
    const size_t o = ((size_t)b * H + kvh * g + j) * n_split + split;
    part_acc[o * Dh + d] = A;
    if (d == 0) {
      part_ml[2 * o] = M;
      part_ml[2 * o + 1] = L;
    }
  }
}

// One block per (b, h): merge the splits' partials by log-sum-exp.
template <typename T>
__global__ void decode_merge(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc,
                             T* __restrict__ out, int n_split, int Dh) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[2 * s]);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = expf(ml[2 * s] - M);
      L += ml[2 * s + 1] * c;
      A += part_acc[(bh * n_split + s) * Dh + d] * c;
    }
    store(&out[bh * Dh + d], A / fmaxf(L, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, void* part_ml, void* part_acc, int B,
           int S, int H, int Hkv, int Dh, int causal, int window, int split_len,
           int n_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_split<T><<<dim3(n_split, Hkv, B), kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(kv_pos), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), S, H, Hkv, Dh, causal, window, split_len,
      scale);
  decode_merge<T><<<B * H, Dh < 128 ? Dh : 128, 0, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), n_split, Dh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,1,H,Dh), k/v (B,S,Hkv,Dh) f32, q_pos (B,) i32, kv_pos (B,S) i32
// → out (B,1,H,Dh). part_ml (B·H·n_split·2) and part_acc (B·H·n_split·Dh)
// are f32 scratch. window <= 0 means no window.
int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* kv_pos, void* out,
                         void* part_ml, void* part_acc, int B, int S, int H,
                         int Hkv, int Dh, int causal, int window, int split_len,
                         int n_split, float scale, void* stream) {
  return launch<float>(q, k, v, q_pos, kv_pos, out, part_ml, part_acc, B, S, H,
                       Hkv, Dh, causal, window, split_len, n_split, scale,
                       stream);
}

// The same for bf16 q/k/v/out (softmax state and accumulation stay f32).
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* q_pos, const void* kv_pos, void* out,
                          void* part_ml, void* part_acc, int B, int S, int H,
                          int Hkv, int Dh, int causal, int window,
                          int split_len, int n_split, float scale,
                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, part_ml, part_acc,
                               B, S, H, Hkv, Dh, causal, window, split_len,
                               n_split, scale, stream);
}

}  // extern "C"
