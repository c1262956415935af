// flash_attention_bwd.cu — the backward of blockwise GQA attention for Hopper (sm_90a).
//
// Replaces flash_jnp._flash_bwd (src/repro/kernels/flash_jnp.py:113-183), the
// custom_vjp of the reference's differentiable attention: given q (B, Sq, H, Dh),
// k/v (B, Skv, Hkv, Dh), the forward's output o and log-sum-exp lse (B, Sq, H) f32
// and the output gradient dO, it recomputes P = exp(scale·QKᵀ − lse) tile by tile
// and returns dQ, dK, dV (dK and dV summed over the g = H / Hkv query heads of
// each kv head), never holding the (Sq, Skv) score matrix.
//   Δ_i   = Σ_d dO_id · O_id
//   dP    = dO · Vᵀ,  dS = P ∘ (dP − Δ)
//   dV    = Pᵀ · dO,  dK = scale · dSᵀ · Q,  dQ = scale · dS · K
// Masking follows the forward (kv_pos >= 0, causal kv_pos <= q_pos, window
// q_pos − kv_pos < window). A row is live when q_pos >= 0 and lse > NEG_INF/2:
// a dead row (no valid key, or an output the forward forced to 0) has P = 0,
// tested before the exp, so exp(s − NEG_INF) never overflows; its dQ is 0 and
// it adds nothing to dK or dV. Keys with kv_pos < 0 get dK = dV = 0.
//
// Bound on the H100: operations. The five products (S, dP, dV, dK, dQ) are
// 10·Dh flops per valid (q, kv) pair and head, against O((Sq + Skv)·H·Dh)
// bytes: at llama3.2-1b's training shape (2, 2048, 32/8, 64) causal that is
// 8.6e10 flops, 0.087 ms at the 989 TFLOP/s of bf16 on the tensor cores.
//
// Design: three launches a call, no atomics, deterministic.
//  - flash_bwd_delta: Δ (B, Sq, H) f32, one warp per row.
//  - dK/dV: one block per (kv tile, kv head, b). It keeps K and V of its
//    tile and walks the q tiles of all g heads of its group, so dK and dV
//    are summed over the group in registers and written once. Per q tile it
//    recomputes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, forms Pᵀ and dSᵀ, and
//    accumulates dV += Pᵀ·dO and dK += dSᵀ·Q. Causal kv tiles launch
//    heaviest first (tile 0 sees every q tile).
//  - dQ: one block per (q tile, head, b), walking the kv tiles with S and dP
//    recomputed and dQ += dS·K; heaviest q tiles first.
// Both skip a tile whose every pair is masked before any tensor byte is
// read, and take ragged Sq and Skv without padding: rows past the end load
// as zeros and are never valid. S and dP are recomputed by both, so they run
// 7 products where the backward needs 5 (1.4x the bound's operations); a
// single pass would sum dQ with atomics, and a call would not repeat bit for
// bit.
//
// bf16: flash_bwd_dkdv_wgmma / flash_bwd_dq_wgmma, built from the forward's
// pieces (hopper.cuh): 384 threads, one producer warpgroup (its first warp
// issues TMA; setmaxnreg 24) and two consumer warpgroups of 64 rows each
// (setmaxnreg 240).
//  - Tiles: the resident tile has 128 rows (K/V in dK/dV, Q/dO in dQ): at
//    the training shape (2, 2048, 32/8, 64) that is 256 dK/dV blocks and
//    1024 dQ blocks for 132 SMs, one block each (the shared memory below).
//    Streamed tiles (Q/dO, or K/V) have 64 rows, so the score accumulators
//    are m64n64 (32 registers each) and dK, dV of Dh 128 (64 registers
//    each) fit beside Sᵀ and dPᵀ in the consumers' 240. They arrive by TMA
//    (4-d maps {Dh, heads, S, B}, 128-byte swizzle; Dh 128 as two boxes, Dh
//    80 in the Dh 128 layout) through a ring of 4 stages with a full and an
//    empty mbarrier each: 96 KB of shared memory at Dh 64, 192 KB at Dh
//    80/128. A stage of the dK/dV ring also carries its q rows' positions,
//    lse·log2(e) (+inf on a dead row, so exp2 gives P = 0 exactly) and Δ.
//  - The producer tests each tile on positions (and, in dK/dV, on the rows'
//    lse) before issuing its TMA, and marks a tile whose every pair is valid,
//    whose consumers then skip the mask.
//  - Products: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dQ: S = Q·Kᵀ, dP = dO·Vᵀ) are
//    wgmma SS with both operands K-major; P and dS are formed on the f32
//    accumulator fragments (masked before exp2) and rounded to bf16 as the
//    register A operand of dV += Pᵀ·dO and dK += dSᵀ·Q (dQ += dS·K), wgmma
//    RS with B MN-major (trans-b), as the forward's P·V.
// Rounding points as the mma.sync design below: bf16 operands; S, dP, P, dS
// and the sums f32; P and dS rounded to bf16 for their products; dq, dk, dv
// rounded once. The f32 tolerance still needs the CUDA cores.
// ptxas (sm_90a, -O3): flash_bwd_dkdv_wgmma<64/80/128> and
// flash_bwd_dq_wgmma<64/80/128> 168 registers at launch (setmaxnreg moves
// them), no spills; ptxas adds a warpgroup wait around each RS product.
//
// bf16 on mma.sync (flash_bwd_dkdv_mma / flash_bwd_dq_mma), the earlier
// design: on no path of the port, timed beside the wgmma kernels
// (_flash_attention_bwd_mma_sync). Blocks of 4 warps over 64-row tiles, warp w
// owning rows 16w..16w+15. Tiles are staged as bf16 in shared memory with
// rows padded to Dh + 8 (16-byte loads from device memory; fragment loads
// free of bank conflicts). The score products are mma.sync m16n8k16 (bf16
// operands, f32 accumulators) with both operands' fragments read straight
// from the row-major tiles; P and dS stay in registers, rounded to bf16 as
// the A fragments of the next products (the m16n8 accumulator layout is the
// k16 A layout), whose B operands (dO, Q, K in [k][n] order) come through
// ldmatrix.trans.
// f32: flash_bwd_dkdv / flash_bwd_dq on the CUDA cores (the f32 tolerance
// needs f32 products): 256 threads, tiles in f32 rows padded to Dh + 4,
// thread (ty, tx) holding rows ty + 16i and columns tx + 16j of a score tile
// and head dims tx + 16e of its output; P and dS staged in shared memory.
// ptxas (sm_90a, -O3): flash_bwd_dq_mma<64/80/128> 131/133/164 registers,
// flash_bwd_dkdv_mma<64/80/128> 192/238/255 (8 bytes spilled at 128);
// flash_bwd_dq<*> 128 (8 bytes spilled at 128), flash_bwd_dkdv<64/80/128>
// 194/214/248.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;             // rows of a q or kv tile
constexpr int kLs = kT + 16;       // row stride of the staged P / dS tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool pair_valid(int qp, int kp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

template <int DH>
__host__ __device__ constexpr int ld() {
  return DH + 4;
}

// rows [r0, r0 + kT) of head `head` of a contiguous (B, S, heads, DH) tensor → dst
// [kT][DH + 4] f32; rows past S are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int b, int S,
                                          int heads, int head, int r0) {
  const float* base = src + ((size_t)b * S * heads + head) * DH;
  for (int i = threadIdx.x; i < kT * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    dst[r * ld<DH>() + d] = r0 + r < S ? base[(size_t)(r0 + r) * heads * DH + d] : 0.f;
  }
}

// acc[i][j] = Σ_d A[ty + 16i][d] · Bm[tx + 16j][d] over the [kT][DH + 4] tiles A, Bm.
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int ty, int tx,
                                         float (&acc)[4][4]) {
  constexpr int L = ld<DH>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * L + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * L + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(a[i].w, c[j].w,
                         fmaf(a[i].z, c[j].z, fmaf(a[i].y, c[j].y, fmaf(a[i].x, c[j].x, acc[i][j]))));
  }
}

// acc[i][e] += Σ_c W[ty + 16i][c] · X[c][tx + 16e] over c < kT: W the staged
// [kT][kLs] weights, X a [kT][DH + 4] tile.
template <int DH>
__device__ __forceinline__ void tile_accumulate(const float* W, const float* X, int ty, int tx,
                                                float (&acc)[4][DH / 16]) {
  constexpr int L = ld<DH>();
#pragma unroll 2
  for (int c = 0; c < kT; c += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const float4*>(&W[(ty + 16 * i) * kLs + c]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int e = 0; e < DH / 16; ++e) {
        const float x = X[(c + cc) * L + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(f4(w[i], cc), x, acc[i][e]);
      }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const T* __restrict__ o,
                                                            const T* __restrict__ dO,
                                                            float* __restrict__ delta,
                                                            int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < DH; d += 32)
    s = fmaf(to_f(o[(size_t)row * DH + d]), to_f(dO[(size_t)row * DH + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int DH>
constexpr size_t dkdv_smem() {
  return (size_t)(4 * kT * ld<DH>() + 2 * kT * kLs + 4 * kT) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos, float* __restrict__ dk,
    float* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int causal, int window, float scale) {
  constexpr int L = ld<DH>(), NE = DH / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kT][L]
  float* vs = ks + kT * L;
  float* qs = vs + kT * L;
  float* dos = qs + kT * L;
  float* pt = dos + kT * L;                      // [kT kv][kLs]  Pᵀ
  float* dst = pt + kT * kLs;                    // [kT kv][kLs]  dSᵀ
  int* kp_s = reinterpret_cast<int*>(dst + kT * kLs);
  int* qp_s = kp_s + kT;
  float* lse_s = reinterpret_cast<float*>(qp_s + kT);   // NEG_INF on dead rows
  float* dl_s = lse_s + kT;

  const int kvh = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kT;
  const int g = H / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_tile<DH>(ks, k, b, Skv, Hkv, kvh, k0);
  load_tile<DH>(vs, v, b, Skv, Hkv, kvh, k0);
  if (tid < kT) kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;

  float dk_acc[4][NE], dv_acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int q0 = 0; q0 < Sq; q0 += kT) {
      __syncthreads();                       // the previous q tile is consumed
      if (tid < kT) {
        const int r = q0 + tid;
        const bool in = r < Sq;
        const int qp = in ? q_pos[(size_t)b * Sq + r] : -2;
        const float ls = in ? lse[((size_t)b * Sq + r) * H + h] : kNegInf;
        qp_s[tid] = qp;
        lse_s[tid] = qp >= 0 && ls > kNegInf / 2 ? ls : kNegInf;
        dl_s[tid] = in ? delta[((size_t)b * Sq + r) * H + h] : 0.f;
      }
      __syncthreads();
      bool valid[4][4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = kp_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          valid[i][j] = lse_s[c] > kNegInf / 2 && pair_valid(qp_s[c], kp, causal, window);
          any = any || valid[i][j];
        }
      }
      if (!__syncthreads_or(any)) continue;  // no valid pair: no Q / dO reads
      load_tile<DH>(qs, q, b, Sq, H, h, q0);
      load_tile<DH>(dos, dO, b, Sq, H, h, q0);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<DH>(ks, qs, ty, tx, s);       // s[i][j] = K_(ty+16i) · Q_(tx+16j)
      tile_dot<DH>(vs, dos, ty, tx, dp);     // dp[i][j] = V_(ty+16i) · dO_(tx+16j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = valid[i][j] ? expf(fmaf(s[i][j], scale, -lse_s[c])) : 0.f;
          pt[(ty + 16 * i) * kLs + c] = p;
          dst[(ty + 16 * i) * kLs + c] = p * (dp[i][j] - dl_s[c]);
        }
      __syncthreads();
      tile_accumulate<DH>(pt, dos, ty, tx, dv_acc);
      tile_accumulate<DH>(dst, qs, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Skv) continue;
    const size_t off = (((size_t)b * Skv + r) * Hkv + kvh) * DH;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      dk[off + tx + 16 * e] = dk_acc[i][e] * scale;
      dv[off + tx + 16 * e] = dv_acc[i][e];
    }
  }
}

template <int DH>
constexpr size_t dq_smem() {
  return (size_t)(4 * kT * ld<DH>() + kT * kLs + 4 * kT) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos, float* __restrict__ dq,
    int Sq, int Skv, int H, int Hkv, int causal, int window, float scale) {
  constexpr int L = ld<DH>(), NE = DH / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kT][L]
  float* dos = qs + kT * L;
  float* ks = dos + kT * L;
  float* vs = ks + kT * L;
  float* ds = vs + kT * L;                       // [kT q][kLs]  dS
  int* qp_s = reinterpret_cast<int*>(ds + kT * kLs);
  int* kp_s = qp_s + kT;
  float* lse_s = reinterpret_cast<float*>(kp_s + kT);
  float* dl_s = lse_s + kT;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;   // heaviest causal tiles first
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_tile<DH>(qs, q, b, Sq, H, h, q0);
  load_tile<DH>(dos, dO, b, Sq, H, h, q0);
  if (tid < kT) {
    const int r = q0 + tid;
    const bool in = r < Sq;
    const int qp = in ? q_pos[(size_t)b * Sq + r] : -2;
    const float ls = in ? lse[((size_t)b * Sq + r) * H + h] : kNegInf;
    qp_s[tid] = qp;
    lse_s[tid] = qp >= 0 && ls > kNegInf / 2 ? ls : kNegInf;
    dl_s[tid] = in ? delta[((size_t)b * Sq + r) * H + h] : 0.f;
  }

  float acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kT) {
    __syncthreads();                         // the previous kv tile is consumed
    if (tid < kT) kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
    __syncthreads();
    bool valid[4][4];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool live = lse_s[r] > kNegInf / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        valid[i][j] = live && pair_valid(qp_s[r], kp_s[tx + 16 * j], causal, window);
        any = any || valid[i][j];
      }
    }
    if (!__syncthreads_or(any)) continue;    // no valid pair: no K / V reads
    load_tile<DH>(ks, k, b, Skv, Hkv, kvh, k0);
    load_tile<DH>(vs, v, b, Skv, Hkv, kvh, k0);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DH>(qs, ks, ty, tx, s);         // s[i][j] = Q_(ty+16i) · K_(tx+16j)
    tile_dot<DH>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i][j] ? expf(fmaf(s[i][j], scale, -lse_s[r])) : 0.f;
        ds[r * kLs + tx + 16 * j] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();
    tile_accumulate<DH>(ds, ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const size_t off = (((size_t)b * Sq + r) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < NE; ++e) dq[off + tx + 16 * e] = acc[i][e] * scale;
  }
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const void* lse, const void* q_pos, const void* kv_pos, void* dq, void* dk,
              void* dv, void* delta, int B, int Sq, int Skv, int H, int Hkv, int causal,
              int window, float scale, cudaStream_t st) {
  constexpr size_t smem_kv = dkdv_smem<DH>(), smem_q = dq_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dO);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const int32_t* qp = static_cast<const int32_t*>(q_pos);
  const int32_t* kp = static_cast<const int32_t*>(kv_pos);
  const int rows = B * Sq * H;
  const int per_block = kThreads / 32;
  flash_bwd_delta<float, DH><<<(rows + per_block - 1) / per_block, kThreads, 0, st>>>(
      static_cast<const float*>(o), tdo, fd, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<DH><<<dim3((Skv + kT - 1) / kT, Hkv, B), kThreads, smem_kv, st>>>(
      tq, tk, tv, tdo, fl, fd, qp, kp, static_cast<float*>(dk), static_cast<float*>(dv), Sq,
      Skv, H, Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<DH><<<dim3((Sq + kT - 1) / kT, H, B), kThreads, smem_q, st>>>(
      tq, tk, tv, tdo, fl, fd, qp, kp, static_cast<float*>(dq), Sq, Skv, H, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const void* lse, const void* q_pos, const void* kv_pos, void* dq, void* dk,
           void* dv, void* delta, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
           int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dh<64>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv,
                            H, Hkv, causal, window, scale, st);
  if (Dh == 80)
    return launch_dh<80>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv,
                            H, Hkv, causal, window, scale, st);
  if (Dh == 128)
    return launch_dh<128>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq,
                             Skv, H, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync m16n8k16, f32 accumulators: the earlier design, on no path
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps; warp w owns rows 16w..16w+15 of its tile

template <int DH>
__host__ __device__ constexpr int lds() {   // bf16 row stride of a staged tile
  return DH + 8;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d (16 x 8) += a (16 x 16, row) · b (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two n8 blocks (columns n0..n0+15) and one k16 step (rows
// k0..k0+15) of a row-major [k][n] tile: ldmatrix with transpose.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// rows [r0, r0 + kT) of head `head` of a contiguous (B, S, heads, DH) bf16 tensor
// → dst [kT][DH + 8] bf16 in 16-byte pieces; rows past S are zeros.
template <int DH>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* __restrict__ src, int b,
                                               int S, int heads, int head, int r0) {
  constexpr int C = DH / 8;
  const __nv_bfloat16* base = src + ((size_t)b * S * heads + head) * DH;
  for (int i = threadIdx.x; i < kT * C; i += kMmaThreads) {
    const int r = i / C, c = i - r * C;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * heads * DH + c * 8);
    *reinterpret_cast<uint4*>(dst + r * lds<DH>() + c * 8) = val;
  }
}

// acc[nb] (16 x 64 as 8 n8 blocks) = A (rows r0.. of a, 16 x DH) · Bᵀ (rows of bt,
// 64 x DH): both tiles row-major [rows][DH], so B's fragments are plain loads.
template <int DH>
__device__ __forceinline__ void mma_scores(const __nv_bfloat16* a, const __nv_bfloat16* bt,
                                           int r0, int lane, float (&acc)[8][4]) {
  constexpr int L = lds<DH>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* ar = a + (r0 + g) * L + 16 * kk + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * L), ld32(ar + 8), ld32(ar + 8 * L + 8)};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const __nv_bfloat16* br = bt + (8 * nb + g) * L + 16 * kk + 2 * t;
      mma16816(acc[nb], af, ld32(br), ld32(br + 8));
    }
  }
}

// acc[nb] (16 x DH) += W (16 x 64, the f32 accumulators of mma_scores rounded to
// bf16 as A fragments) · X (64 x DH, a row-major [k][n] tile).
template <int DH>
__device__ __forceinline__ void mma_accumulate(const float (&w)[8][4], const __nv_bfloat16* x,
                                               int lane, float (&acc)[DH / 8][4]) {
  constexpr int L = lds<DH>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {                  // k16 steps over the 64 columns of W
    const uint32_t af[4] = {pack_bf16(w[2 * j][0], w[2 * j][1]),
                            pack_bf16(w[2 * j][2], w[2 * j][3]),
                            pack_bf16(w[2 * j + 1][0], w[2 * j + 1][1]),
                            pack_bf16(w[2 * j + 1][2], w[2 * j + 1][3])};
#pragma unroll
    for (int nb = 0; nb < DH / 8; nb += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, x + (16 * j + (lane & 15)) * L + 8 * nb + 8 * (lane >> 4));
      mma16816(acc[nb], af, bf[0], bf[1]);
      mma16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

template <int DH>
constexpr size_t dkdv_mma_smem() {
  return (size_t)4 * kT * lds<DH>() * 2 + 4 * kT * 4;
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
    int Hkv, int causal, int window, float scale) {
  constexpr int L = lds<DH>(), NB = DH / 8;
  extern __shared__ uint4 smem_v[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_v);   // [kT][L]
  __nv_bfloat16* vs = ks + kT * L;
  __nv_bfloat16* qs = vs + kT * L;
  __nv_bfloat16* dos = qs + kT * L;
  int* kp_s = reinterpret_cast<int*>(dos + kT * L);
  int* qp_s = kp_s + kT;
  float* lse_s = reinterpret_cast<float*>(qp_s + kT);   // NEG_INF on dead rows
  float* dl_s = lse_s + kT;

  const int kvh = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kT;
  const int g = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int gr = lane >> 2, tc = 2 * (lane & 3);

  load_tile_bf16<DH>(ks, k, b, Skv, Hkv, kvh, k0);
  load_tile_bf16<DH>(vs, v, b, Skv, Hkv, kvh, k0);
  if (tid < kT) kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int q0 = 0; q0 < Sq; q0 += kT) {
      __syncthreads();                       // the previous q tile is consumed
      if (tid < kT) {
        const int r = q0 + tid;
        const bool in = r < Sq;
        const int qp = in ? q_pos[(size_t)b * Sq + r] : -2;
        const float ls = in ? lse[((size_t)b * Sq + r) * H + h] : kNegInf;
        qp_s[tid] = qp;
        lse_s[tid] = qp >= 0 && ls > kNegInf / 2 ? ls : kNegInf;
        dl_s[tid] = in ? delta[((size_t)b * Sq + r) * H + h] : 0.f;
      }
      __syncthreads();
      // this thread's pairs: kv rows r0 + gr (+8), q columns 8nb + tc (+1)
      const int kp0 = kp_s[r0 + gr], kp1 = kp_s[r0 + gr + 8];
      bool any = false;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nb + tc + e;
          const bool live = lse_s[c] > kNegInf / 2;
          any = any || (live && (pair_valid(qp_s[c], kp0, causal, window) ||
                                 pair_valid(qp_s[c], kp1, causal, window)));
        }
      if (!__syncthreads_or(any)) continue;  // no valid pair: no Q / dO reads
      load_tile_bf16<DH>(qs, q, b, Sq, H, h, q0);
      load_tile_bf16<DH>(dos, dO, b, Sq, H, h, q0);
      __syncthreads();

      float st[8][4], dpt[8][4];
      mma_scores<DH>(ks, qs, r0, lane, st);      // Sᵀ = K·Qᵀ (kv rows x q columns)
      mma_scores<DH>(vs, dos, r0, lane, dpt);    // dPᵀ = V·dOᵀ
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nb + tc + (e & 1);
          const bool ok = lse_s[c] > kNegInf / 2 &&
                          pair_valid(qp_s[c], (e & 2) ? kp1 : kp0, causal, window);
          const float p = ok ? expf(fmaf(st[nb][e], scale, -lse_s[c])) : 0.f;
          st[nb][e] = p;                         // Pᵀ
          dpt[nb][e] = p * (dpt[nb][e] - dl_s[c]);   // dSᵀ
        }
      mma_accumulate<DH>(st, dos, lane, dv_acc);   // dV += Pᵀ·dO
      mma_accumulate<DH>(dpt, qs, lane, dk_acc);   // dK += dSᵀ·Q
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + r0 + gr + 8 * half;
    if (r >= Skv) continue;
    const size_t off = (((size_t)b * Skv + r) * Hkv + kvh) * DH + tc;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * nb) =
          pack_bf16(dk_acc[nb][2 * half] * scale, dk_acc[nb][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * nb) =
          pack_bf16(dv_acc[nb][2 * half], dv_acc[nb][2 * half + 1]);
    }
  }
}

template <int DH>
constexpr size_t dq_mma_smem() {
  return (size_t)4 * kT * lds<DH>() * 2 + 4 * kT * 4;
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int Hkv, int causal, int window,
    float scale) {
  constexpr int L = lds<DH>(), NB = DH / 8;
  extern __shared__ uint4 smem_v[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_v);   // [kT][L]
  __nv_bfloat16* dos = qs + kT * L;
  __nv_bfloat16* ks = dos + kT * L;
  __nv_bfloat16* vs = ks + kT * L;
  int* qp_s = reinterpret_cast<int*>(vs + kT * L);
  int* kp_s = qp_s + kT;
  float* lse_s = reinterpret_cast<float*>(kp_s + kT);
  float* dl_s = lse_s + kT;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;   // heaviest causal tiles first
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int gr = lane >> 2, tc = 2 * (lane & 3);

  load_tile_bf16<DH>(qs, q, b, Sq, H, h, q0);
  load_tile_bf16<DH>(dos, dO, b, Sq, H, h, q0);
  if (tid < kT) {
    const int r = q0 + tid;
    const bool in = r < Sq;
    const int qp = in ? q_pos[(size_t)b * Sq + r] : -2;
    const float ls = in ? lse[((size_t)b * Sq + r) * H + h] : kNegInf;
    qp_s[tid] = qp;
    lse_s[tid] = qp >= 0 && ls > kNegInf / 2 ? ls : kNegInf;
    dl_s[tid] = in ? delta[((size_t)b * Sq + r) * H + h] : 0.f;
  }
  __syncthreads();
  // this thread's rows r0 + gr and r0 + gr + 8
  const int qp0 = qp_s[r0 + gr], qp1 = qp_s[r0 + gr + 8];
  const float ls0 = lse_s[r0 + gr], ls1 = lse_s[r0 + gr + 8];
  const float dl0 = dl_s[r0 + gr], dl1 = dl_s[r0 + gr + 8];
  const bool live0 = ls0 > kNegInf / 2, live1 = ls1 > kNegInf / 2;

  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kT) {
    __syncthreads();                         // the previous kv tile is consumed
    if (tid < kT) kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kp_s[8 * nb + tc + e];
        any = any || (live0 && pair_valid(qp0, kp, causal, window)) ||
              (live1 && pair_valid(qp1, kp, causal, window));
      }
    if (!__syncthreads_or(any)) continue;    // no valid pair: no K / V reads
    load_tile_bf16<DH>(ks, k, b, Skv, Hkv, kvh, k0);
    load_tile_bf16<DH>(vs, v, b, Skv, Hkv, kvh, k0);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_scores<DH>(qs, ks, r0, lane, s);     // S = Q·Kᵀ
    mma_scores<DH>(dos, vs, r0, lane, dp);   // dP = dO·Vᵀ
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        const int kp = kp_s[8 * nb + tc + (e & 1)];
        const bool ok = (hi ? live1 : live0) && pair_valid(hi ? qp1 : qp0, kp, causal, window);
        const float p = ok ? expf(fmaf(s[nb][e], scale, -(hi ? ls1 : ls0))) : 0.f;
        s[nb][e] = p * (dp[nb][e] - (hi ? dl1 : dl0));   // dS
      }
    mma_accumulate<DH>(s, ks, lane, acc);    // dQ += dS·K
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + r0 + gr + 8 * half;
    if (r >= Sq) continue;
    const size_t off = (((size_t)b * Sq + r) * H + h) * DH + tc;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(dq + off + 8 * nb) =
          pack_bf16(acc[nb][2 * half] * scale, acc[nb][2 * half + 1] * scale);
  }
}

template <int DH>
int launch_mma_dh(const void* q, const void* k, const void* v, const void* o, const void* dO,
                  const void* lse, const void* q_pos, const void* kv_pos, void* dq, void* dk,
                  void* dv, void* delta, int B, int Sq, int Skv, int H, int Hkv, int causal,
                  int window, float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  constexpr size_t smem_kv = dkdv_mma_smem<DH>(), smem_q = dq_mma_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const int32_t* qp = static_cast<const int32_t*>(q_pos);
  const int32_t* kp = static_cast<const int32_t*>(kv_pos);
  const int rows = B * Sq * H;
  const int per_block = kThreads / 32;
  flash_bwd_delta<T, DH><<<(rows + per_block - 1) / per_block, kThreads, 0, st>>>(
      static_cast<const T*>(o), tdo, fd, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_mma<DH><<<dim3((Skv + kT - 1) / kT, Hkv, B), kMmaThreads, smem_kv, st>>>(
      tq, tk, tv, tdo, fl, fd, qp, kp, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H,
      Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_mma<DH><<<dim3((Sq + kT - 1) / kT, H, B), kMmaThreads, smem_q, st>>>(
      tq, tk, tv, tdo, fl, fd, qp, kp, static_cast<T*>(dq), Sq, Skv, H, Hkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

int launch_mma(const void* q, const void* k, const void* v, const void* o, const void* dO,
               const void* lse, const void* q_pos, const void* kv_pos, void* dq, void* dk,
               void* dv, void* delta, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
               int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_mma_dh<64>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv,
                             H, Hkv, causal, window, scale, st);
  if (Dh == 80)
    return launch_mma_dh<80>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv,
                             H, Hkv, causal, window, scale, st);
  if (Dh == 128)
    return launch_mma_dh<128>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq,
                              Skv, H, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kBwdThreads = 3 * kWg;     // a producer warpgroup, two consumer warpgroups
constexpr int kBig = 128;                // rows of the resident tile (K/V, or Q/dO)
constexpr int kSmall = 64;               // rows of a streamed tile (Q/dO, or K/V)
constexpr int kStages = 4;               // ring stages of streamed tiles
constexpr int kProducerRegs = 24, kConsumerRegs = 240;   // setmaxnreg
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEnd = -1, kPartial = 0, kFull = 1;   // kinds of ring entries

template <int DP>
struct BwdLayout {                       // byte offsets in dynamic shared memory
  static constexpr int kHalves = DP / 64;                 // 64-wide head-dim boxes
  static constexpr int kBigTile = kHalves * kBig * kRow;  // one resident tile
  static constexpr int kSmallTile = kHalves * kSmall * kRow;
  static constexpr int kOffRing = 2 * kBigTile;           // [kStages][2 streamed tiles]
  static constexpr int kOffPos = kOffRing + kStages * 2 * kSmallTile;   // int [kStages][kSmall]
  static constexpr int kOffLse = kOffPos + kStages * kSmall * 4;        // f32 [kStages][kSmall]
  static constexpr int kOffDelta = kOffLse + kStages * kSmall * 4;      // f32 [kStages][kSmall]
  static constexpr int kOffTile = kOffDelta + kStages * kSmall * 4;     // int [kStages]
  static constexpr int kOffBar = kOffTile + kStages * 4;                // u64 [1 + 2 kStages]
  static constexpr int kBytes = kOffBar + (1 + 2 * kStages) * 8 + 1024;   // + alignment
};

// The producer's part of a (row) tile test, for rows [r0, r0 + n): each lane
// reads rows r0 + lane + 32e of a (B, S) position array; invalid rows (past S
// or position < 0) count as absent. → lo / hi over the present positions
// (INT_MAX / INT_MIN when none) and whether every row is present.
__device__ __forceinline__ void pos_range(const int32_t* __restrict__ pos, int S, int r0, int n,
                                          int lane, int& lo, int& hi, bool& all) {
  lo = INT_MAX;
  hi = INT_MIN;
  all = true;
  for (int r = lane; r < n; r += 32) {
    const int p = r0 + r < S ? pos[r0 + r] : -1;
    if (p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      all = false;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  all = __all_sync(0xffffffffu, all);
}

// A q row's log-sum-exp in the exp2 domain, +inf on a dead row (past Sq,
// q_pos < 0, or no valid key): exp2(s·scale·log2e − lse2) is then 0 exactly.
__device__ __forceinline__ float row_lse2(const float* __restrict__ lse, int qp, int in_row,
                                          size_t idx) {
  const float ls = in_row ? lse[idx] : kNegInf;
  return in_row && qp >= 0 && ls > kNegInf / 2 ? ls * kLog2e : INFINITY;
}

// dK, dV: one block per (kv tile of kBig rows, kv head, b); causal tiles launch
// heaviest first (blockIdx.z = 0 sees every q tile).
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
    int Hkv, int causal, int window, float scale_log2, float scale) {
  constexpr int DP = padded_dh<DH>();
  using L = BwdLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  // TMA boxes with 128-byte swizzle need 1024-byte aligned destinations
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  int* pos_s = reinterpret_cast<int*>(smem + L::kOffPos);
  float* lse_s = reinterpret_cast<float*>(smem + L::kOffLse);
  float* dl_s = reinterpret_cast<float*>(smem + L::kOffDelta);
  int* tile_s = reinterpret_cast<int*>(smem + L::kOffTile);

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBig;
  const int g = H / Hkv, tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer: warp 0 streams the Q / dO tiles of every head of the group ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) return;
    const int lane = tid;
    int klo, khi;
    bool kall;
    pos_range(kv_pos + (size_t)b * Skv, Skv, k0, kBig, lane, klo, khi, kall);
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kBigTile);
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load(smem + hf * kBig * kRow, &tm_k, kv_full, hf * 64, kvh, k0, b);
        tma_load(smem + L::kBigTile + hf * kBig * kRow, &tm_v, kv_full, hf * 64, kvh, k0, b);
      }
    }
    int stage = 0, phase = 0;
    const int nq = klo <= khi ? (Sq + kSmall - 1) / kSmall : 0;   // no valid key: no q tile
    for (int hh = 0; hh < g; ++hh) {
      const int h = kvh * g + hh;
      for (int t = 0; t < nq; ++t) {
        const int q0 = t * kSmall;
        int qp[2];
        float l2[2];
        bool hit = false, all = kall;    // all: every pair valid for every live row
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = q0 + 32 * e + lane, in = r < Sq;
          qp[e] = in ? q_pos[(size_t)b * Sq + r] : -2;
          l2[e] = row_lse2(lse, qp[e], in, ((size_t)b * Sq + r) * H + h);
          const bool live = l2[e] != INFINITY;
          hit = hit || (live && (!causal || qp[e] >= klo) &&
                        (window <= 0 || (long long)qp[e] - khi < window));
          all = all && (!live || ((!causal || qp[e] >= khi) &&
                                  (window <= 0 || (long long)qp[e] - klo < window)));
        }
        if (!__any_sync(0xffffffffu, hit)) continue;   // no valid pair: no bytes
        const bool no_mask = __all_sync(0xffffffffu, all);
        mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = q0 + 32 * e + lane, i = stage * kSmall + 32 * e + lane;
          pos_s[i] = qp[e];
          lse_s[i] = l2[e];
          dl_s[i] = r < Sq ? delta[((size_t)b * Sq + r) * H + h] : 0.f;
        }
        if (lane == 0) tile_s[stage] = no_mask ? kFull : kPartial;
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * L::kSmallTile);
          uint8_t* qs = smem + L::kOffRing + stage * 2 * L::kSmallTile;
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tma_load(qs + hf * kSmall * kRow, &tm_q, &full[stage], hf * 64, h, q0, b);
            tma_load(qs + L::kSmallTile + hf * kSmall * kRow, &tm_do, &full[stage], hf * 64,
                     h, q0, b);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      tile_s[stage] = kEnd;
      mbar_arrive(&full[stage]);
    }
  } else {
    // ---- consumer warpgroups: 64 kv rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWg - 1, warp = (tid % kWg) / 32, lane = tid & 31;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;   // this thread's kv rows
    const int kp0 = k0 + r0 < Skv ? kv_pos[(size_t)b * Skv + k0 + r0] : -1;
    const int kp1 = k0 + r1 < Skv ? kv_pos[(size_t)b * Skv + k0 + r1] : -1;
    const uint32_t sk = smem_u32(smem) + wg * 64 * kRow;
    const uint32_t sv = sk + L::kBigTile;
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

    mbar_wait(kv_full, 0);
    int stage = 0, phase = 0;
    for (;;) {
      mbar_wait(&full[stage], phase);
      const int kind = tile_s[stage];
      if (kind == kEnd) break;
      const uint32_t sq = smem_u32(smem + L::kOffRing + stage * 2 * L::kSmallTile);
      const uint32_t sdo = sq + L::kSmallTile;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (kv rows x q columns), K-major operands
      float st[kSmall / 2], dpt[kSmall / 2];
#pragma unroll
      for (int j = 0; j < kSmall / 2; ++j) st[j] = dpt[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {   // 16 head dims per step
        const uint32_t da = (kk / 4) * kBig * kRow + (kk % 4) * 32;
        const uint32_t db = (kk / 4) * kSmall * kRow + (kk % 4) * 32;
        wgmma_m64n64_ss(st, sw128_desc(sk + da, 16, 8 * kRow), sw128_desc(sq + db, 16, 8 * kRow),
                        1);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t da = (kk / 4) * kBig * kRow + (kk % 4) * 32;
        const uint32_t db = (kk / 4) * kSmall * kRow + (kk % 4) * 32;
        wgmma_m64n64_ss(dpt, sw128_desc(sv + da, 16, 8 * kRow),
                        sw128_desc(sdo + db, 16, 8 * kRow), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // st[j] is (kv row r0 + 8·((j/2)%2), q column 8·(j/4) + 2·(lane%4) + j%2):
      // Pᵀ = exp2(s·scale·log2e − lse2), masked before the exp; dSᵀ = Pᵀ ∘ (dPᵀ − Δ)
      const int* qp = pos_s + stage * kSmall;
      const float* l2 = lse_s + stage * kSmall;
      const float* dl = dl_s + stage * kSmall;
#pragma unroll
      for (int nb = 0; nb < kSmall / 8; ++nb) {
        const int c = 8 * nb + 2 * (lane & 3);
        const float2 lc = *reinterpret_cast<const float2*>(l2 + c);
        const float2 dc = *reinterpret_cast<const float2*>(dl + c);
        const int2 qc = *reinterpret_cast<const int2*>(qp + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * nb + e;
          const float x = fmaf(st[j], scale_log2, -((e & 1) ? lc.y : lc.x));
          const bool ok = kind == kFull ||
                          pair_valid((e & 1) ? qc.y : qc.x, (e & 2) ? kp1 : kp0, causal, window);
          const float p = ex2(ok ? x : -INFINITY);
          st[j] = p;
          dpt[j] = p * (dpt[j] - ((e & 1) ? dc.y : dc.x));
        }
      }
      uint32_t pf[kSmall / 16][4], dsf[kSmall / 16][4];   // bf16 A fragments of the k16 steps
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          dsf[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }

      // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q MN-major (trans-b)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)   // 16 q rows per step
        wgmma_pv<DP>(dv_acc, pf[kk],
                     sw128_desc(sdo + kk * 16 * kRow, kSmall * kRow, 8 * kRow));
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)
        wgmma_pv<DP>(dk_acc, dsf[kk],
                     sw128_desc(sq + kk * 16 * kRow, kSmall * kRow, 8 * kRow));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // dk_acc[j] is (kv row r0 + 8·((j/2)%2), head dim 8·(j/4) + 2·(lane%4) + j%2)
    const size_t row = (size_t)Hkv * DH;
    __nv_bfloat16* k_out = dk + ((size_t)b * Skv + k0 + r0) * row + (size_t)kvh * DH +
                           (lane & 3) * 2;
    __nv_bfloat16* v_out = dv + (k_out - dk);
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      if (k0 + r0 < Skv) {
        *reinterpret_cast<uint32_t*>(k_out + nb * 8) =
            pack_bf16(dk_acc[4 * nb] * scale, dk_acc[4 * nb + 1] * scale);
        *reinterpret_cast<uint32_t*>(v_out + nb * 8) =
            pack_bf16(dv_acc[4 * nb], dv_acc[4 * nb + 1]);
      }
      if (k0 + r1 < Skv) {
        *reinterpret_cast<uint32_t*>(k_out + 8 * row + nb * 8) =
            pack_bf16(dk_acc[4 * nb + 2] * scale, dk_acc[4 * nb + 3] * scale);
        *reinterpret_cast<uint32_t*>(v_out + 8 * row + nb * 8) =
            pack_bf16(dv_acc[4 * nb + 2], dv_acc[4 * nb + 3]);
      }
    }
  }
}

// dQ: one block per (q tile of kBig rows, head, b); causal tiles launch
// heaviest first (blockIdx.z counts down).
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int Hkv, int causal, int window,
    float scale_log2, float scale) {
  constexpr int DP = padded_dh<DH>();
  using L = BwdLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* pos_s = reinterpret_cast<int*>(smem + L::kOffPos);
  int* tile_s = reinterpret_cast<int*>(smem + L::kOffTile);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBig;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer: warp 0 streams the K / V tiles ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) return;
    const int lane = tid, kvh = h / (H / Hkv);
    int qlo, qhi;
    bool qall;
    pos_range(q_pos + (size_t)b * Sq, Sq, q0, kBig, lane, qlo, qhi, qall);
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * L::kBigTile);
      for (int hf = 0; hf < L::kHalves; ++hf) {
        tma_load(smem + hf * kBig * kRow, &tm_q, q_full, hf * 64, h, q0, b);
        tma_load(smem + L::kBigTile + hf * kBig * kRow, &tm_do, q_full, hf * 64, h, q0, b);
      }
    }
    const bool any_q = qlo <= qhi;
    const long long lo = window > 0 ? (long long)qlo - window + 1 : LLONG_MIN;
    const long long hi = causal ? (long long)qhi : LLONG_MAX;
    const int nk = (Skv + kSmall - 1) / kSmall;
    int stage = 0, phase = 0;
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * kSmall;
      int kp[kSmall / 32];
      bool hit = false, all = true;      // all: every pair valid for every q row present
#pragma unroll
      for (int e = 0; e < kSmall / 32; ++e) {
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
      for (int e = 0; e < kSmall / 32; ++e) pos_s[stage * kSmall + 32 * e + lane] = kp[e];
      if (lane == 0) tile_s[stage] = no_mask ? kFull : kPartial;
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[stage], 2 * L::kSmallTile);
        uint8_t* ks = smem + L::kOffRing + stage * 2 * L::kSmallTile;
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tma_load(ks + hf * kSmall * kRow, &tm_k, &full[stage], hf * 64, kvh, k0, b);
          tma_load(ks + L::kSmallTile + hf * kSmall * kRow, &tm_v, &full[stage], hf * 64, kvh,
                   k0, b);
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
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWg - 1, warp = (tid % kWg) / 32, lane = tid & 31;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;   // this thread's q rows
    const int in0 = q0 + r0 < Sq, in1 = q0 + r1 < Sq;
    const int qp0 = in0 ? q_pos[(size_t)b * Sq + q0 + r0] : -2;
    const int qp1 = in1 ? q_pos[(size_t)b * Sq + q0 + r1] : -2;
    const size_t i0 = ((size_t)b * Sq + q0 + r0) * H + h, i1 = i0 + (size_t)8 * H;
    const float l0 = row_lse2(lse, qp0, in0, i0), l1 = row_lse2(lse, qp1, in1, i1);
    const float d0 = in0 ? delta[i0] : 0.f, d1 = in1 ? delta[i1] : 0.f;
    const uint32_t sq = smem_u32(smem) + wg * 64 * kRow;
    const uint32_t sdo = sq + L::kBigTile;
    float acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;

    mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (;;) {
      mbar_wait(&full[stage], phase);
      const int kind = tile_s[stage];
      if (kind == kEnd) break;
      const uint32_t sk = smem_u32(smem + L::kOffRing + stage * 2 * L::kSmallTile);
      const uint32_t sv = sk + L::kSmallTile;

      // S = Q·Kᵀ and dP = dO·Vᵀ (q rows x kv columns), K-major operands
      float s[kSmall / 2], dp[kSmall / 2];
#pragma unroll
      for (int j = 0; j < kSmall / 2; ++j) s[j] = dp[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t da = (kk / 4) * kBig * kRow + (kk % 4) * 32;
        const uint32_t db = (kk / 4) * kSmall * kRow + (kk % 4) * 32;
        wgmma_m64n64_ss(s, sw128_desc(sq + da, 16, 8 * kRow), sw128_desc(sk + db, 16, 8 * kRow),
                        1);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t da = (kk / 4) * kBig * kRow + (kk % 4) * 32;
        const uint32_t db = (kk / 4) * kSmall * kRow + (kk % 4) * 32;
        wgmma_m64n64_ss(dp, sw128_desc(sdo + da, 16, 8 * kRow),
                        sw128_desc(sv + db, 16, 8 * kRow), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // s[j] is (q row r0 + 8·((j/2)%2), kv column 8·(j/4) + 2·(lane%4) + j%2)
      const int* kp = pos_s + stage * kSmall;
      uint32_t dsf[kSmall / 16][4];
#pragma unroll
      for (int nb = 0; nb < kSmall / 8; ++nb) {
        const int2 kc = *reinterpret_cast<const int2*>(kp + 8 * nb + 2 * (lane & 3));
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * nb + e;
          const bool hi_row = e & 2;
          const float x = fmaf(s[j], scale_log2, -(hi_row ? l1 : l0));
          const bool ok = kind == kFull ||
                          pair_valid(hi_row ? qp1 : qp0, (e & 1) ? kc.y : kc.x, causal, window);
          const float p = ex2(ok ? x : -INFINITY);
          ds[e] = p * (dp[j] - (hi_row ? d1 : d0));
        }
        // n8 block nb is half of k16 step nb / 2: registers 2·(nb % 2) and + 1
        dsf[nb / 2][2 * (nb % 2)] = pack_bf16(ds[0], ds[1]);
        dsf[nb / 2][2 * (nb % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS·K, K MN-major (trans-b)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)   // 16 kv rows per step
        wgmma_pv<DP>(acc, dsf[kk], sw128_desc(sk + kk * 16 * kRow, kSmall * kRow, 8 * kRow));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    __nv_bfloat16* o0 = dq + i0 * DH + (lane & 3) * 2;
    __nv_bfloat16* o1 = o0 + (size_t)8 * H * DH;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      if (in0)
        *reinterpret_cast<uint32_t*>(o0 + nb * 8) =
            pack_bf16(acc[4 * nb] * scale, acc[4 * nb + 1] * scale);
      if (in1)
        *reinterpret_cast<uint32_t*>(o1 + nb * 8) =
            pack_bf16(acc[4 * nb + 2] * scale, acc[4 * nb + 3] * scale);
    }
  }
}

template <int DH>
int launch_wgmma_dh(const void* q, const void* k, const void* v, const void* o, const void* dO,
                    const void* lse, const void* q_pos, const void* kv_pos, void* dq, void* dk,
                    void* dv, void* delta, int B, int Sq, int Skv, int H, int Hkv, int causal,
                    int window, float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  CUtensorMap q_big, do_big, k_big, v_big, q_small, do_small, k_small, v_small;
  if (!make_map(&q_big, q, DH, H, Sq, B, kBig) || !make_map(&do_big, dO, DH, H, Sq, B, kBig) ||
      !make_map(&k_big, k, DH, Hkv, Skv, B, kBig) ||
      !make_map(&v_big, v, DH, Hkv, Skv, B, kBig) ||
      !make_map(&q_small, q, DH, H, Sq, B, kSmall) ||
      !make_map(&do_small, dO, DH, H, Sq, B, kSmall) ||
      !make_map(&k_small, k, DH, Hkv, Skv, B, kSmall) ||
      !make_map(&v_small, v, DH, Hkv, Skv, B, kSmall))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = BwdLayout<padded_dh<DH>()>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const int32_t* qp = static_cast<const int32_t*>(q_pos);
  const int32_t* kp = static_cast<const int32_t*>(kv_pos);
  const int rows = B * Sq * H;
  const int per_block = kThreads / 32;
  flash_bwd_delta<T, DH><<<(rows + per_block - 1) / per_block, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), fd, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dkdv_wgmma<DH><<<dim3(Hkv, B, (Skv + kBig - 1) / kBig), kBwdThreads, smem, st>>>(
      q_small, do_small, k_big, v_big, fl, fd, qp, kp, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, H, Hkv, causal, window, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_wgmma<DH><<<dim3(H, B, (Sq + kBig - 1) / kBig), kBwdThreads, smem, st>>>(
      q_big, do_big, k_small, v_small, fl, fd, qp, kp, static_cast<T*>(dq), Sq, Skv, H, Hkv,
      causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dO,
                 const void* lse, const void* q_pos, const void* kv_pos, void* dq, void* dk,
                 void* dv, void* delta, int B, int Sq, int Skv, int H, int Hkv, int Dh,
                 int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_wgmma_dh<64>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq,
                               Skv, H, Hkv, causal, window, scale, st);
  if (Dh == 80)
    return launch_wgmma_dh<80>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq,
                               Skv, H, Hkv, causal, window, scale, st);
  if (Dh == 128)
    return launch_wgmma_dh<128>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq,
                                Skv, H, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}


}  // namespace

extern "C" {

// q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh), o and dO (B,Sq,H,Dh) f32, lse (B,Sq,H)
// f32 from the forward, q_pos (B,Sq) i32, kv_pos (B,Skv) i32 → dq, dk, dv in
// the inputs' shapes; delta is (B,Sq,H) f32 scratch. Dh is 64, 80 or 128;
// window <= 0 means no window.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* dO, const void* lse, const void* q_pos,
                            const void* kv_pos, void* dq, void* dk, void* dv, void* delta,
                            int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                            int window, float scale, void* stream) {
  return launch_f32(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv, H,
                    Hkv, Dh, causal, window, scale, stream);
}

// The same for bf16 q/k/v/o/dO/dq/dk/dv (16-byte aligned: TMA reads q, k, v
// and dO), on the tensor cores with wgmma.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dO, const void* lse, const void* q_pos,
                             const void* kv_pos, void* dq, void* dk, void* dv, void* delta,
                             int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                             int window, float scale, void* stream) {
  return launch_wgmma(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv, H,
                      Hkv, Dh, causal, window, scale, stream);
}

// The earlier mma.sync design on the same inputs: on no path of the port,
// timed beside flash_attention_bwd_bf16.
int flash_attention_bwd_bf16_mma_sync(const void* q, const void* k, const void* v,
                                      const void* o, const void* dO, const void* lse,
                                      const void* q_pos, const void* kv_pos, void* dq, void* dk,
                                      void* dv, void* delta, int B, int Sq, int Skv, int H,
                                      int Hkv, int Dh, int causal, int window, float scale,
                                      void* stream) {
  return launch_mma(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, delta, B, Sq, Skv, H, Hkv,
                    Dh, causal, window, scale, stream);
}

}  // extern "C"
