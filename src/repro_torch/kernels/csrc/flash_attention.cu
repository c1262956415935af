// flash_attention.cu — blockwise online-softmax GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:76): q (B, Sq, H, Dh) attends over
// k/v (B, Skv, Hkv, Dh), GQA by h // g, masked by positions (kv_pos >= 0,
// causal kv_pos <= q_pos, optional window q_pos - kv_pos < window; positions
// may be out of order), scale Dh^-0.5, online softmax in f32, fully masked
// tiles skipped, out = acc / max(l, 1e-30), rows with q_pos < 0 exactly 0,
// output in q's dtype.
//
// Bound on the H100: operations. At prefill every K/V tile is reused by all
// kBQ query rows of a block, so the work is ~4·Sq·Skv·Dh flops (halved by
// the causal skip) against O((Sq + Skv)·Dh) bytes; at (4, 2048, 32, 64) that
// is far above the ~295 flops per byte where the tensor cores stop waiting
// on memory. This first version runs its products on the CUDA cores in f32
// (67 TFLOP/s peak), not on the tensor cores, so it sits well above the
// bf16 bound: wgmma and TMA are work for a later change.
//
// Design. The TPU grid (B, H, nq, nk) walks kv in order with the (m, l, acc)
// state in VMEM. Here one block of 256 threads owns (q tile of 64 rows, one
// query head, b) and walks the kv tiles of 64 rows itself, with the state in
// registers: thread (ty, tx) holds rows ty*4..+3 and score columns tx*4..+3,
// and accumulates head dims tx*4 + 64*j. Q and K tiles sit transposed in
// shared memory (float4 reads along rows and columns), V in natural layout,
// and P is staged transposed for the P·V product. The GQA head is read
// through h // g, never repeated. A kv tile is skipped when no (q, kv) pair
// of it is valid, tested on positions (any order) with __syncthreads_or
// before any K/V byte is read. Masked scores are forced to p = 0 explicitly,
// so a row that has seen only masked keys (m = -1e30) adds nothing. The
// ragged ends of Sq and Skv are masked in the kernel, never padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // kv rows per tile
constexpr int kLd = kBQ + 4;       // row stride of the transposed tiles (16-byte rows)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// max / sum over the 16 lanes that share one row (lanes tx = 0..15)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool pair_valid(int qp, int kp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

template <int DH>
constexpr size_t smem_bytes() {
  return (size_t)(2 * DH * kLd + kBK * DH + kBK * kLd) * sizeof(float) +
         (size_t)(kBQ + kBK) * sizeof(int);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
    T* __restrict__ out, int Sq, int Skv, int H, int Hkv, int causal, int window,
    float scale) {
  constexpr int kDj = DH / 64;     // 64-wide head-dim groups per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [DH][kLd]  q tile, transposed
  float* kt = qt + DH * kLd;                     // [DH][kLd]  k tile, transposed
  float* vs = kt + DH * kLd;                     // [kBK][DH]  v tile
  float* pt = vs + kBK * DH;                     // [kBK][kLd] p tile, transposed
  int* qp_s = reinterpret_cast<int*>(pt + kBK * kLd);   // [kBQ]
  int* kp_s = qp_s + kBQ;                                // [kBK]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = (size_t)H * DH, kv_row = (size_t)Hkv * DH;
  const T* qb = q + ((size_t)b * Sq * H + h) * DH;
  const T* kb = k + ((size_t)b * Skv * Hkv + kvh) * DH;
  const T* vb = v + ((size_t)b * Skv * Hkv + kvh) * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    qt[d * kLd + r] = q0 + r < Sq ? to_f(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }
  if (tid < kBQ) qp_s[tid] = q0 + tid < Sq ? q_pos[(size_t)b * Sq + q0 + tid] : -2;

  float m[4], l[4], acc[4][4 * kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kDj; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Skv + kBK - 1) / kBK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the previous tile is consumed
    if (tid < kBK) kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
    __syncthreads();

    bool valid[4][4];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qp_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        valid[i][j] = pair_valid(qp, kp_s[tx * 4 + j], causal, window);
        any = any || valid[i][j];
      }
    }
    if (!__syncthreads_or(any)) continue;  // fully masked tile: no K/V reads

    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i - r * DH;
      const bool in = k0 + r < Skv;
      kt[d * kLd + r] = in ? to_f(kb[(size_t)(k0 + r) * kv_row + d]) : 0.f;
      vs[r * DH + d] = in ? to_f(vb[(size_t)(k0 + r) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLd + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kt[d * kLd + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += f4(a, i) * f4(c, j);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[i][j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i][j] ? expf(s[i][j] - m_new) : 0.f;
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = p;
        psum += p;
      }
      l[i] = l[i] * corr + row_sum(psum);
#pragma unroll
      for (int j = 0; j < 4 * kDj; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBK; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(&pt[r * kLd + ty * 4]);
#pragma unroll
      for (int jj = 0; jj < kDj; ++jj) {
        const float4 w = *reinterpret_cast<const float4*>(&vs[r * DH + jj * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj * 4 + e] += f4(p, i) * f4(w, e);
      }
    }
  }
  __syncthreads();                         // qp_s is read below even when nk == 0

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const bool pad = qp_s[r] < 0;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + q0 + r) * H + h) * DH;
#pragma unroll
    for (int jj = 0; jj < kDj; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&o[jj * 64 + tx * 4 + e], pad ? 0.f : acc[i][jj * 4 + e] / denom);
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* q_pos,
              const void* kv_pos, void* out, int B, int Sq, int Skv, int H,
              int Hkv, int causal, int window, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(kv_pos),
      static_cast<T*>(out), Sq, Skv, H, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, int B, int Sq, int Skv, int H, int Hkv,
           int Dh, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dh<T, 64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                            causal, window, scale, st);
  if (Dh == 128)
    return launch_dh<T, 128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                             causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh) f32, q_pos (B,Sq) i32, kv_pos (B,Skv) i32
// → out (B,Sq,H,Dh). Dh is 64 or 128; window <= 0 means no window.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out, int B,
                        int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                        int window, float scale, void* stream) {
  return launch<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, Dh,
                       causal, window, scale, stream);
}

// The same for bf16 q/k/v/out (softmax state and accumulation stay f32).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* kv_pos, void* out, int B,
                         int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                               Dh, causal, window, scale, stream);
}

}  // extern "C"
