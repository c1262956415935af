// flash_attention.cu — blockwise online-softmax GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:76): q (B, Sq, H, Dh) attends over
// k/v (B, Skv, Hkv, Dh), GQA by h // g, masked by positions (kv_pos >= 0,
// causal kv_pos <= q_pos, optional window q_pos - kv_pos < window; positions
// may be out of order), scale Dh^-0.5, online softmax in f32, masked tiles
// skipped, out = acc / max(l, 1e-30), rows with q_pos < 0 exactly 0, output
// in q's dtype. Sq and Skv may be ragged: nothing is padded on the host.
// Dh is 64, 80 or 128. When the caller passes an lse buffer (training: the
// backward in flash_attention_bwd.cu recomputes P from it), each row's
// log-sum-exp of its scaled scores is written as f32 (B, Sq, H), NEG_INF on a
// row with no valid key or with q_pos < 0; prefill passes null and pays
// nothing.
//
// Bound on the H100: operations. At prefill every K/V tile is reused by all
// the query rows of a block, so the work is 4·Dh flops per valid (q, kv)
// pair and head against O((Sq + Skv)·Dh) bytes: at (4, 2048, 32/8, 64)
// causal that is 6.9e10 flops, 0.070 ms at the 989 TFLOP/s of bf16 on the
// tensor cores, far above the ~295 flops per byte where they stop waiting on
// memory.
//
// bf16: flash_fwd_wgmma, on the tensor cores. One block of 288 threads per
// (q tile of 128 rows, query head, b): two consumer warpgroups of 64 q rows
// each and one producer warp. The q tiles launch heaviest first (blockIdx.z
// counts down), so the long causal rows start before the short ones.
//  - Loads: TMA with 128-byte swizzle. The tensors are strided (B, S, H, Dh),
//    so each tensor map is 4-d {Dh, heads, S, B} and a tile is a box of 64
//    head dims x 1 head x rows x 1 batch row (Dh 128 is two boxes; Dh 80 runs
//    in the Dh 128 layout, its second box zero past head dim 79). The Q
//    tile is loaded once; K/V tiles of 128 rows go through a ring of stages
//    (4 at Dh 64, 2 at Dh 128; 147 / 162 KB of shared memory) with a full
//    and an empty mbarrier each. Rows past Sq or Skv arrive as zeros and
//    their kv_pos is taken as -1.
//  - Skipping: the producer reads each tile's kv_pos (four per lane) and
//    issues its TMA only if some valid kv_pos lies in [min q_pos - window +
//    1, max q_pos] of the block's valid query rows (without a window only the
//    upper end, without causal only the lower end): conservative for
//    positions in any order. It hands the consumers each tile's kv_pos
//    through the ring, and marks a tile whose every pair is valid for every
//    valid query row, so that the consumers skip its mask; -1 ends the walk.
//  - S = Q·Kᵀ: wgmma m64n128k16, both operands K-major in shared memory.
//  - Mask and online softmax on the accumulator fragments: a thread holds
//    rows r and r + 8 of its warp's 16; row max and sum run over the 4
//    threads of a quad (shfl_xor 1, 2), l is reduced once at the end.
//    Masked scores are -inf and a row that has seen no valid key yet takes
//    0 as its max, so every masked p is exp2(-inf) = 0 exactly and such a
//    row adds nothing. exp is exp2 with log2(e) folded into the scale.
//  - O += P·V: wgmma m64n{Dh}k16 with P from registers (the f32 score
//    fragment of m64n128 lines up with the bf16 A fragments of k16) and V
//    MN-major in shared memory (trans-b), f32 accumulators.
// Rounding points: q, k, v are bf16 operands; S, the softmax state and O
// accumulate in f32; P is rounded to bf16 for P·V while l sums the f32 p;
// the output is rounded to bf16 once.
// ptxas (sm_90a, -O3): flash_fwd_wgmma<64> 155 registers, <80> and <128> 168;
// no spills.
//
// CUDA cores: flash_fwd<T, DH>, the earlier design. Its f32 instance is the f32
// kernel, kept because the f32 tolerance (2e-5) cannot be met with bf16 or
// TF32 operands; only the f32 parity checks run it. Its bf16 instance
// (flash_attention_bf16_cuda_cores) is on no path of the port: it is the
// earlier design that chip_smoke.py times beside the tensor-core kernel.
// One block of 256 threads owns (q tile of 64 rows, one query head, b) and
// walks the kv tiles of 64 rows itself, with the state in registers: thread
// (ty, tx) holds rows ty*4..+3 and score columns tx*4..+3, and accumulates
// head dims tx*4 + 64*j. Q and K tiles sit transposed in shared memory (f32,
// float4 reads along rows and columns), V in natural layout, and P is staged
// transposed for the P·V product. A kv tile is skipped when no (q, kv) pair
// of it is valid, tested on positions with __syncthreads_or before any K/V
// byte is read.
// ptxas (sm_90a, -O3): flash_fwd<T, 64> 99 registers, <T, 80> and <T, 128>
// 127, both dtypes; no spills.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA cores: f32, and bf16 as the yardstick
// ---------------------------------------------------------------------------

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
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
    int causal, int window, float scale) {
  constexpr int kDj = (DH + 63) / 64;   // 64-wide head-dim groups per thread
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
        if (jj * 64 + tx * 4 >= DH) continue;   // Dh 80: the second group is 16 wide
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
    for (int jj = 0; jj < kDj; ++jj) {
      if (jj * 64 + tx * 4 >= DH) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&o[jj * 64 + tx * 4 + e], pad ? 0.f : acc[i][jj * 4 + e] / denom);
    }
    if (lse != nullptr && tx == 0)         // natural-log sum of the row's exp(scores)
      lse[((size_t)b * Sq + q0 + r) * H + h] =
          !pad && l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* q_pos,
              const void* kv_pos, void* out, void* lse, int B, int Sq, int Skv, int H,
              int Hkv, int causal, int window, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(kv_pos),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Skv, H, Hkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, void* lse, int B, int Sq, int Skv, int H,
           int Hkv, int Dh, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dh<T, 64>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv,
                            causal, window, scale, st);
  if (Dh == 80)
    return launch_dh<T, 80>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv,
                            causal, window, scale, st);
  if (Dh == 128)
    return launch_dh<T, 128>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv,
                             causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kBM = 128;                 // q rows per block: two consumer warpgroups
constexpr int kBN = 128;                 // kv rows per tile
constexpr int kFwdThreads = 2 * kWg + 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEnd = -1, kPartial = 0, kFull = 1;   // kinds of ring entries

template <int DH>
struct Layout {                          // byte offsets in dynamic shared memory
  static constexpr int kHalves = DH / 64;                // 64-wide head-dim boxes
  static constexpr int kStages = DH == 64 ? 4 : 2;
  static constexpr int kQ = kHalves * kBM * kRow;        // the Q tile
  static constexpr int kKV = kHalves * kBN * kRow;       // one K or V tile
  static constexpr int kOffK = kQ;
  static constexpr int kOffV = kOffK + kStages * kKV;
  static constexpr int kOffPos = kOffV + kStages * kKV;  // int [kStages][kBN]
  static constexpr int kOffTile = kOffPos + kStages * kBN * 4;   // int [kStages]
  static constexpr int kOffBar = kOffTile + kStages * 8;         // u64 [1 + 2 kStages]
  static constexpr int kBytes = kOffBar + (1 + 2 * kStages) * 8 + 1024;  // + alignment
};

// Dh 80 runs in the Dh 128 layout (padded_dh in hopper.cuh): QKᵀ takes only
// the 5 k-steps of the real dims, P·V runs at N = 128 and the zero columns of
// V give accumulators that are never stored.

template <int DH>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int32_t* __restrict__ q_pos,
    const int32_t* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int H, int Hkv, int causal, int window,
    float scale_log2) {
  constexpr int DP = padded_dh<DH>();
  using L = Layout<DP>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  // TMA boxes with 128-byte swizzle need 1024-byte aligned destinations
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* pos_s = reinterpret_cast<int*>(smem + L::kOffPos);
  int* tile_s = reinterpret_cast<int*>(smem + L::kOffTile);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nk = (Skv + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kWg) {
    // ---- producer warp ----
    const int kvh = h / (H / Hkv);
    int qlo = INT_MAX, qhi = INT_MIN;
    for (int r = lane; r < kBM && q0 + r < Sq; r += 32) {
      const int p = q_pos[(size_t)b * Sq + q0 + r];
      if (p >= 0) {
        qlo = min(qlo, p);
        qhi = max(qhi, p);
      }
    }
    qlo = __reduce_min_sync(0xffffffffu, qlo);
    qhi = __reduce_max_sync(0xffffffffu, qhi);
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load(smem + hf * kBM * kRow, &tm_q, q_full, hf * 64, h, q0, b);
    }
    const bool any_q = qlo <= qhi;
    const long long lo = window > 0 ? (long long)qlo - window + 1 : LLONG_MIN;
    const long long hi = causal ? (long long)qhi : LLONG_MAX;
    int stage = 0, phase = 0;
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * kBN;
      int kp[kBN / 32];
      bool hit = false, all = true;      // all: every pair valid for every valid row
#pragma unroll
      for (int e = 0; e < kBN / 32; ++e) {
        const int r = k0 + 32 * e + lane;
        kp[e] = r < Skv ? kv_pos[(size_t)b * Skv + r] : -1;
        hit = hit || (kp[e] >= 0 && kp[e] >= lo && kp[e] <= hi);
        all = all && kp[e] >= 0 && (!causal || kp[e] <= qlo) &&
              (window <= 0 || (long long)qhi - kp[e] < window);
      }
      if (!__any_sync(0xffffffffu, any_q && hit)) continue;   // no valid pair: no bytes
      const bool no_mask = __all_sync(0xffffffffu, all);
      mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
      for (int e = 0; e < kBN / 32; ++e) pos_s[stage * kBN + 32 * e + lane] = kp[e];
      if (lane == 0) tile_s[stage] = no_mask ? kFull : kPartial;
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[stage], 2 * L::kKV);
        uint8_t* ks = smem + L::kOffK + stage * L::kKV;
        uint8_t* vs = smem + L::kOffV + stage * L::kKV;
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tma_load(ks + hf * kBN * kRow, &tm_k, &full[stage], hf * 64, kvh, k0, b);
          tma_load(vs + hf * kBN * kRow, &tm_v, &full[stage], hf * 64, kvh, k0, b);
        }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      tile_s[stage] = kEnd;
      mbar_arrive(&full[stage]);
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    const int wg = tid / kWg, warp = (tid % kWg) / 32;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const int qp0 = q0 + r0 < Sq ? q_pos[(size_t)b * Sq + q0 + r0] : -1;
    const int qp1 = q0 + r1 < Sq ? q_pos[(size_t)b * Sq + q0 + r1] : -1;
    const uint32_t sq = smem_u32(smem) + wg * 64 * kRow;
    float o[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
    // running max in the exp2 domain (-inf until a row sees a valid key)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (;;) {
      mbar_wait(&full[stage], phase);
      const int kind = tile_s[stage];
      if (kind == kEnd) break;
      const uint32_t sk = smem_u32(smem + L::kOffK + stage * L::kKV);
      const uint32_t sv = smem_u32(smem + L::kOffV + stage * L::kKV);

      float s[kBN / 2];
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) s[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {   // 16 head dims per step
        const uint32_t dq = (kk / 4) * kBM * kRow + (kk % 4) * 32;
        const uint32_t dk = (kk / 4) * kBN * kRow + (kk % 4) * 32;
        wgmma_qk(s, sw128_desc(sq + dq, 16, 8 * kRow), sw128_desc(sk + dk, 16, 8 * kRow),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[j] is (row r0 + 8·((j/2)%2), column 8·(j/4) + 2·(lane%4) + j%2)
      if (kind == kPartial) {              // masked scores are -inf
        const int* kp = pos_s + stage * kBN;
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) {
          const int kpos = kp[(j >> 2) * 8 + (lane & 3) * 2 + (j & 1)];
          if (!pair_valid((j & 2) ? qp1 : qp0, kpos, causal, window)) s[j] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) {
        if (j & 2)
          mx1 = fmaxf(mx1, s[j]);
        else
          mx0 = fmaxf(mx0, s[j]);
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      // a row with no valid key yet subtracts 0: its p = exp2(-inf) = 0
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0, ms1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = ex2(m0 - ms0), c1 = ex2(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) {
        s[j] = ex2(fmaf(s[j], scale_log2, (j & 2) ? -ms1 : -ms0));
        if (j & 2)
          ls1 += s[j];
        else
          ls0 += s[j];
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
      uint32_t pf[kBN / 16][4];            // P as the bf16 A fragments of the k16 steps
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) o[j] *= (j & 2) ? c1 : c0;

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)   // 16 kv rows per step
        wgmma_pv<DP>(o, pf[kk], sw128_desc(sv + kk * 16 * kRow, kBN * kRow, 8 * kRow));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (lse != nullptr && (lane & 3) == 0) {   // m is in the exp2 domain: ln = m·ln2 + ln l
      constexpr float kLn2 = 0.6931471805599453f;
      float* lp = lse + ((size_t)b * Sq + q0 + r0) * H + h;
      if (q0 + r0 < Sq) lp[0] = qp0 >= 0 && l0 > 0.f ? m0 * kLn2 + logf(l0) : kNegInf;
      if (q0 + r1 < Sq)
        lp[(size_t)8 * H] = qp1 >= 0 && l1 > 0.f ? m1 * kLn2 + logf(l1) : kNegInf;
    }
    __nv_bfloat16* o0 = out + (((size_t)b * Sq + q0 + r0) * H + h) * DH + (lane & 3) * 2;
    __nv_bfloat16* o1 = o0 + (size_t)8 * H * DH;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      if (q0 + r0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + nb * 8) =
            qp0 < 0 ? 0u : pack_bf16(o[4 * nb] * inv0, o[4 * nb + 1] * inv0);
      if (q0 + r1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + nb * 8) =
            qp1 < 0 ? 0u : pack_bf16(o[4 * nb + 2] * inv1, o[4 * nb + 3] * inv1);
    }
  }
}

template <int DH>
int launch_wgmma_dh(const void* q, const void* k, const void* v, const void* q_pos,
                    const void* kv_pos, void* out, void* lse, int B, int Sq, int Skv, int H,
                    int Hkv, int causal, int window, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, DH, H, Sq, B, kBM) || !make_map(&tk, k, DH, Hkv, Skv, B, kBN) ||
      !make_map(&tv, v, DH, Hkv, Skv, B, kBN))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Layout<padded_dh<DH>()>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  flash_fwd_wgmma<DH><<<grid, kFwdThreads, smem, st>>>(
      tq, tk, tv, static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(kv_pos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Skv, H, Hkv, causal,
      window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh) f32, q_pos (B,Sq) i32, kv_pos (B,Skv) i32
// → out (B,Sq,H,Dh) and, when lse is not null, the rows' log-sum-exp
// (B,Sq,H) f32 (NEG_INF on a row with no valid key), for the backward.
// Dh is 64, 80 or 128; window <= 0 means no window.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out, void* lse,
                        int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                        int window, float scale, void* stream) {
  return launch<float>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv, Dh,
                       causal, window, scale, stream);
}

// The same for bf16 q/k/v/out (16-byte aligned), on the tensor cores.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* kv_pos, void* out, void* lse,
                         int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                         int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_wgmma_dh<64>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv,
                               causal, window, scale, st);
  if (Dh == 80)
    return launch_wgmma_dh<80>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv,
                               causal, window, scale, st);
  if (Dh == 128)
    return launch_wgmma_dh<128>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv,
                                causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The CUDA-core design on bf16 q/k/v/out (softmax state and accumulation f32):
// not on any path of the port, timed beside flash_attention_bf16.
int flash_attention_bf16_cuda_cores(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* kv_pos, void* out,
                                    void* lse, int B, int Sq, int Skv, int H, int Hkv,
                                    int Dh, int causal, int window, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, Hkv, Dh,
                               causal, window, scale, stream);
}

}  // extern "C"
