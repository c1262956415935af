// ssd_scan.cu — the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan_pallas
// (src/repro/kernels/ssd_scan.py:70). Per (b, h), over chunks of Q steps,
// with la = dt·A (A = -exp(A_log) < 0) and cum the inclusive prefix sum of
// la inside the chunk:
//   intra:  y_i += Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · dt_j · x_j
//   inter:  y_i += exp(cum_i) · C_i · S_inᵀ
//   skip:   y_i += D · x_i
//   carry:  S_out = exp(cum_Q)·S_in + Σ_j exp(cum_Q − cum_j)·dt_j·(x_j ⊗ B_j)
// B and C are shared per group (h // (H / G)). y has x's dtype; the state is
// f32 throughout.
//
// The exponent of the intra term is masked before exp: only j ≤ i is ever
// evaluated, so every factor is ≤ 1. cum is summed in f64: with mamba2's
// decays it reaches −1000s inside one chunk, where an f32 prefix sum keeps
// ~1e-4 of absolute precision and every exp(cum_i − cum_j) inherits it as a
// relative error; the f64 differences are exact to f32 before exp. The
// reference evaluates exp over the whole Q×Q square and multiplies by tril
// afterwards; once a chunk's summed decay passes ~88 the upper entries are
// inf and inf·0 is NaN, which mamba2-1.3b's own init reaches
// (A_log = log(1..64), Q = 128). A ragged last chunk loads zeros for the
// steps past S (dt = 0: identity steps) and stores only the rows < S, so
// nothing is padded on the host.
//
// Bound on the H100 in bf16: bytes. At (B, S, H, P, G, N, Q) = (4, 2048, 64,
// 64, 1, 128, 128) the function reads x, B, C and dt and writes y and the
// final state once: 1.5e8 bytes, 0.044 ms at 3.35 TB/s, against 3.0e10
// flops of the chunked form, 0.031 ms at 989 TFLOP/s.
//
// bf16: three launches, each a parallel grid; no block walks the chunks in
// order except the state pass. The B·nc·H·P·N f32 chunk states and B·nc·H
// decays are scratch the wrapper allocates.
//  1. ssd_states_mma, grid (chunk, b, group x tile of 4 heads), 106 KB of
//     shared memory: per head the f64 warp scan of cum, w_j = exp(cum_Q −
//     cum_j)·dt_j, and s_c = (w⊙x)ᵀ·B, a (P x Q)·(Q x N) product with
//     mma.sync m16n8k16 bf16 → f32 (ldmatrix.trans for both operands);
//     writes s_c and the chunk decay exp(cum_Q). The next head's x arrives
//     by cp.async while the current head computes.
//  2. ssd_state_pass, grid over (float4 of H·P·N, b): each thread walks the
//     chunks, S_in[c] = state; state = decay_c·state + s_c, in place over
//     the chunk states; writes the final state. Elementwise, bound by bytes.
//  3. ssd_output_mma, grid (chunk, b, group x tile of 8 heads), one block
//     of 8 warps per SM (216 KB of shared memory): C·Bᵀ once per block for
//     the causal 16x16 blocks (f32, in shared memory) and reused for every
//     head of the tile — only the decay differs between heads. The next
//     head's x and S_in are brought by cp.async into a second buffer while
//     the current head computes. Per head, warp (k, half) owns the 16-row
//     blocks k and Q/16 − 1 − k (so every warp has the same causal work)
//     and one half of P: y = exp(cum_i)·(C·S_inᵀ) + (C·Bᵀ ⊙ exp(cum_i −
//     cum_j) ⊙ dt_j)·x + D·x, both products on mma.sync; the att fragment
//     is built in registers from the C·Bᵀ fragment (the f32 C layout of
//     m16n8 is the A layout of k16), branch-free. cum is scanned in f64
//     and kept as an f32 hi + lo pair, so cum_i − cum_j is exact to f32
//     without f64 arithmetic per element. y is staged in shared memory and
//     stored in 16-byte rows.
//  At the prefill shape passes 1 and 3 have 1024 and 512 blocks.
// Rounding points: x, B, C are bf16 operands already. Every other operand of
// the products enters as a hi + lo pair of bf16 (about 16 bits of mantissa):
// w⊙x in pass 1, att and S_in in pass 3: as single bf16 values they make
// the output miss the 2e-2 tolerance at mamba2's shape and decays (the
// design model in tests/test_torch_ssd.py shows it with an init state).
// S_in stays f32 in memory and in the state pass; C·Bᵀ, the products and y
// accumulate in f32; y is rounded to bf16 once.
// ptxas (sm_90a, -O3): ssd_states_mma 96 registers, ssd_state_pass 40,
// ssd_output_mma 124; no spills.
//
// CUDA cores: ssd_chunk_scan<T>, the earlier design. Its f32 instance is the
// f32 kernel, kept because the f32 tolerance (1e-4) cannot be met with bf16
// or TF32 operands; only the f32 parity checks run it. Its bf16 instance
// (ssd_scan_bf16_cuda_cores) is on no path of the port: it is the earlier
// design that chip_smoke.py times beside the tensor-core passes. One block
// of 256 threads owns one (b, h) and walks its chunks in order with the
// state in shared memory: the chunk's x, B, C tiles (f32), the state and one
// 32-row block of the masked Q×Q matrix fit in ~215 KB of dynamic shared
// memory at (64, 128, 128). Per chunk: warp 0 scans the decays; then for
// each 32-row block, C·Bᵀ for the columns j ≤ i only, its masked weights,
// then y = att·x + exp(cum)·C·Sᵀ + D·x; finally the state carry.
// ptxas (sm_90a, -O3): ssd_chunk_scan<T> 64 registers, both dtypes, with a
// 16-byte stack frame and 12 bytes of spill stores and loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA cores: f32, and bf16 as the yardstick
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;      // 8 warps
constexpr int kRB = 32;            // rows of the Q×Q matrix per row block
constexpr int kMaxP = 64;          // P: a multiple of 32 up to 64
constexpr int kMaxN = 128;         // N: a multiple of 32 up to 128
constexpr int kMaxQ = 128;         // Q: a multiple of 32 up to 128

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  return acc + a.w * b.w;
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared-memory floats: x [Q][P], B and C [Q][N+4], state [P][N+4], one row
// block of the masked matrix [kRB][Q+4], cum [Q] (f64), dt and the carry
// weights [Q] each.
__host__ __device__ constexpr size_t smem_floats(int P, int N, int Q) {
  return (size_t)Q * P + 2 * (size_t)Q * (N + 4) + (size_t)P * (N + 4) +
         (size_t)kRB * (Q + 4) + 4 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dp,
    const float* __restrict__ init, T* __restrict__ y,
    float* __restrict__ final_state, int S, int H, int G, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int ldn = N + 4, ldq = Q + 4;
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][P]
  float* bs = xs + Q * P;                        // [Q][ldn]
  float* cs = bs + Q * ldn;                      // [Q][ldn]
  float* st = cs + Q * ldn;                      // [P][ldn]
  float* att = st + P * ldn;                     // [kRB][ldq]
  double* cum = reinterpret_cast<double*>(att + kRB * ldq);   // [Q], 16-byte aligned
  float* dts = reinterpret_cast<float*>(cum + Q);              // [Q]
  float* wj = dts + Q;                           // [Q]

  const int h = blockIdx.x, b = blockIdx.y;
  const int gi = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_pc = P / 32, n_nc = N / 32, n_pr = P / 8;
  const float A = -expf(A_log[h]);
  const float Dh = Dp[h];
  const size_t state_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    st[p * ldn + n] = init ? init[state_off + i] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    __syncthreads();                     // the previous chunk is consumed
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i - j * P;
      xs[i] = s0 + j < S ? to_f(x[(((size_t)b * S + s0 + j) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      const bool in = s0 + j < S;
      const size_t o = (((size_t)b * S + s0 + j) * G + gi) * N + n;
      bs[j * ldn + n] = in ? to_f(Bm[o]) : 0.f;
      cs[j * ldn + n] = in ? to_f(Cm[o]) : 0.f;
    }
    if (tid < Q) dts[tid] = s0 + tid < S ? dt[((size_t)b * S + s0 + tid) * H + h] : 0.f;
    __syncthreads();

    if (warp == 0) {                     // cum: inclusive prefix sum of dt·A, f64
      const int per = Q / 32;
      double loc[kMaxQ / 32];
      double run = 0.0;
#pragma unroll
      for (int e = 0; e < kMaxQ / 32; ++e) {
        if (e < per) {
          run += (double)(dts[lane * per + e] * A);
          loc[e] = run;
        }
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
#pragma unroll
      for (int e = 0; e < kMaxQ / 32; ++e)
        if (e < per) cum[lane * per + e] = excl + loc[e];
    }
    __syncthreads();
    if (tid < Q) wj[tid] = expf((float)(cum[Q - 1] - cum[tid])) * dts[tid];

    for (int rb = 0; rb < Q / kRB; ++rb) {
      const int i0 = rb * kRB;
      // att[ri][j] for rows ri = warp + 8r and columns j = lane + 32cc ≤ i0 + 31
      {
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) a[r][cc] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&cs[(i0 + warp + 8 * r) * ldn + n]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (cc <= rb) {
              const float4 bv =
                  *reinterpret_cast<const float4*>(&bs[(lane + 32 * cc) * ldn + n]);
#pragma unroll
              for (int r = 0; r < 4; ++r) a[r][cc] = dot4(cv[r], bv, a[r][cc]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ri = warp + 8 * r, i = i0 + ri;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (cc <= rb) {
              const int j = lane + 32 * cc;
              att[ri * ldq + j] =
                  j <= i ? a[r][cc] * expf((float)(cum[i] - cum[j])) * dts[j] : 0.f;
            }
          }
        }
      }
      __syncthreads();

      // y rows i0 + ri (ri = warp + 8r), channels p = lane + 32pc
      {
        float yv[4][kMaxP / 32], iv[4][kMaxP / 32];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int pc = 0; pc < kMaxP / 32; ++pc) yv[r][pc] = iv[r][pc] = 0.f;
        for (int j = 0; j < i0 + kRB; j += 4) {
          float4 av[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            av[r] = *reinterpret_cast<const float4*>(&att[(warp + 8 * r) * ldq + j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int pc = 0; pc < kMaxP / 32; ++pc) {
              if (pc < n_pc) {
                const float xv = xs[(j + e) * P + lane + 32 * pc];
#pragma unroll
                for (int r = 0; r < 4; ++r) yv[r][pc] += f4(av[r], e) * xv;
              }
            }
          }
        }
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&cs[(i0 + warp + 8 * r) * ldn + n]);
#pragma unroll
          for (int pc = 0; pc < kMaxP / 32; ++pc) {
            if (pc < n_pc) {
              const float4 sv =
                  *reinterpret_cast<const float4*>(&st[(lane + 32 * pc) * ldn + n]);
#pragma unroll
              for (int r = 0; r < 4; ++r) iv[r][pc] = dot4(cv[r], sv, iv[r][pc]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + warp + 8 * r;
          if (s0 + i >= S) continue;
          const float ec = expf((float)cum[i]);
          T* yr = y + (((size_t)b * S + s0 + i) * H + h) * P;
#pragma unroll
          for (int pc = 0; pc < kMaxP / 32; ++pc) {
            if (pc < n_pc) {
              const int p = lane + 32 * pc;
              store(&yr[p], yv[r][pc] + ec * iv[r][pc] + Dh * xs[i * P + p]);
            }
          }
        }
      }
      __syncthreads();                   // att and the state are read
    }

    // state carry: st[p][n] = exp(cum_Q)·st + Σ_j wj·x[j][p]·B[j][n]
    {
      const float decay = expf((float)cum[Q - 1]);
      float sacc[kMaxP / 8][kMaxN / 32];
#pragma unroll
      for (int r = 0; r < kMaxP / 8; ++r)
#pragma unroll
        for (int nn = 0; nn < kMaxN / 32; ++nn) sacc[r][nn] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float wv = wj[j];
        float bv[kMaxN / 32];
#pragma unroll
        for (int nn = 0; nn < kMaxN / 32; ++nn)
          bv[nn] = nn < n_nc ? bs[j * ldn + lane + 32 * nn] : 0.f;
#pragma unroll
        for (int r = 0; r < kMaxP / 8; ++r) {
          if (r < n_pr) {
            const float xv = xs[j * P + warp + 8 * r] * wv;
#pragma unroll
            for (int nn = 0; nn < kMaxN / 32; ++nn) sacc[r][nn] += xv * bv[nn];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxP / 8; ++r) {
        if (r < n_pr) {
#pragma unroll
          for (int nn = 0; nn < kMaxN / 32; ++nn) {
            if (nn < n_nc) {
              const int idx = (warp + 8 * r) * ldn + lane + 32 * nn;
              st[idx] = decay * st[idx] + sacc[r][nn];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    final_state[state_off + i] = st[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, const void* Dp, const void* init, void* y,
           void* final_state, int Bb, int S, int H, int G, int P, int N, int Q,
           void* stream) {
  if (P % 32 || P > kMaxP || N % 32 || N > kMaxN || Q % 32 || Q > kMaxQ ||
      G < 1 || H % G || S < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_scan<T><<<dim3(H, Bb), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(final_state), S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: chunk-parallel on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPad = 8;      // bf16 row padding: rows 16 bytes apart mod 128 (ldmatrix)
typedef __nv_bfloat16 bf16;

// Four 8x8 bf16 matrices; lanes 8i..8i+7 address the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// exp(cum_i − cum_j)·dt_j, the exponent masked to -inf for j > i before exp
// (exp2(-inf) = 0); cum_i − cum_j from the hi + lo pairs is exact to f32.
__device__ __forceinline__ float decay_dt(int i, int j, float hi_i, float lo_i, float hi_j,
                                          float lo_j, float dt_j) {
  return ex2(kLog2e * (j <= i ? (hi_i - hi_j) + (lo_i - lo_j) : -INFINITY)) * dt_j;
}

// (a, b) as a hi + lo pair of packed bf16: hi = bf16(·), lo = bf16(· − hi).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Inclusive f64 prefix sums of dt·A over one chunk of Q = 32·per steps by one
// warp: lane l gets steps l·per .. l·per + per − 1 in c. Returns the total.
__device__ __forceinline__ double warp_cum(const float* dts, float A, int per, int lane,
                                           double (&c)[kMaxQ / 32]) {
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < kMaxQ / 32; ++e) {
    if (e < per) {
      run += (double)(dts[lane * per + e] * A);
      c[e] = run;
    }
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int e = 0; e < kMaxQ / 32; ++e)
    if (e < per) c[e] += excl;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// 16 bytes global → shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, nval) of a (rows, width) bf16 tile, row stride ld_src elements,
// into shared memory (row stride ld_dst) by cp.async; zeros past nval.
__device__ __forceinline__ void copy_rows(bf16* dst, int ld_dst, const bf16* src,
                                          size_t ld_src, int rows, int nval, int width) {
  const int w8 = width / 8;
  for (int i = threadIdx.x; i < rows * w8; i += blockDim.x) {
    const int j = i / w8, e = (i - j * w8) * 8;
    cp_async16(dst + j * ld_dst + e, src + (j < nval ? j * ld_src + e : 0), j < nval);
  }
}

// The group and first head of this block's tile of HT heads.
__device__ __forceinline__ void head_tile(int H, int G, int HT, int& g, int& h0) {
  const int R = H / G, tiles = R / HT;
  g = blockIdx.z / tiles;
  h0 = g * R + (blockIdx.z % tiles) * HT;
}

size_t states_smem(int P, int N, int Q, int HT) {
  return (size_t)Q * (N + kPad) * 2 + 2 * (size_t)Q * (P + kPad) * 2 +
         2 * (size_t)Q * P * 2 + (size_t)HT * Q * 4;
}

// 1. chunk states s_c = (w⊙x)ᵀ·B and decays exp(cum_Q), per (chunk, b, head).
// kBwd: the backward's Σ_i exp(cum_i)·dy_i ⊗ C_i, called with (dy, C) in
// place of (x, B) and w_i = exp(cum_i) (0 past S); decay is not written.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads) ssd_states_mma(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const bf16* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ decay, int S, int H, int G, int P,
    int N, int Q, int HT) {
  extern __shared__ float4 smem_states[];
  const int ldn = N + kPad, ldp = P + kPad;
  bf16* bs = reinterpret_cast<bf16*>(smem_states);   // [Q][ldn]  B chunk
  bf16* wxh = bs + Q * ldn;                          // [Q][ldp]  w⊙x of one head: hi
  bf16* wxl = wxh + Q * ldp;                         // [Q][ldp]  and lo
  bf16* xr = wxl + Q * ldp;                          // [2][Q][P] x as loaded
  float* ws = reinterpret_cast<float*>(xr + 2 * Q * P);  // [HT][Q]  dt, then w

  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  int g, h0;
  head_tile(H, G, HT, g, h0);
  const int s0 = c * Q, nval = min(Q, S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto fetch = [&](int hh) {           // x of head tile hh into buffer hh % 2
    copy_rows(xr + (hh & 1) * Q * P, P, x + (((size_t)b * S + s0) * H + h0 + hh) * P,
              (size_t)H * P, Q, nval, P);
    cp_async_commit();
  };

  copy_rows(bs, ldn, Bm + (((size_t)b * S + s0) * G + g) * N, (size_t)G * N, Q, nval, N);
  fetch(0);
  for (int i = tid; i < HT * Q; i += kThreads) {
    const int hh = i / Q, j = i - hh * Q;
    ws[i] = j < nval ? dt[((size_t)b * S + s0 + j) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (warp < HT) {                     // w_j = exp(cum_Q − cum_j)·dt_j; decay exp(cum_Q)
    const int h = h0 + warp, per = Q / 32;
    float* wr = ws + warp * Q;
    double cum[kMaxQ / 32];
    const double total = warp_cum(wr, -expf(A_log[h]), per, lane, cum);
    float wv[kMaxQ / 32];
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e) {
      if (e < per) {
        if (kBwd)
          wv[e] = lane * per + e < nval ? expf((float)cum[e]) : 0.f;
        else
          wv[e] = expf((float)(total - cum[e])) * wr[lane * per + e];
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e)
      if (e < per) wr[lane * per + e] = wv[e];
    if (!kBwd && lane == 0) decay[((size_t)b * nc + c) * H + h] = expf((float)total);
  }

  // warp tile of s_c: p rows 32·wm .. +31, n columns 32·wn .. +31
  const int wm = warp >> 2, wn = warp & 3;
  const bool active = 32 * wm < P && 32 * wn < N;
  const int mat = lane >> 3, r8 = lane & 7, g4 = lane >> 2, t4 = lane & 3;
  const int p8 = P / 8;
  for (int hh = 0; hh < HT; ++hh) {
    if (hh + 1 < HT) {
      fetch(hh + 1);                   // overlaps head hh
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // x of head hh (and B, w) are in
    const int h = h0 + hh;
    const float* w = ws + hh * Q;
    const bf16* xh = xr + (hh & 1) * Q * P;
    for (int i = tid; i < Q * p8; i += kThreads) {   // w⊙x as bf16 hi + lo
      const int j = i / p8, e = (i - j * p8) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(xh + j * P + e);
      const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float wj = w[j];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(pv[u]);
        split_bf16(f.x * wj, f.y * wj, hi[u], lo[u]);
      }
      *reinterpret_cast<uint4*>(wxh + j * ldp + e) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(wxl + j * ldp + e) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    if (!active) continue;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += 16) {
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)   // B: j rows, n columns
        ldsm_x4_t(bf[np], bs + (k0 + r8 + (mat & 1) * 8) * ldn + 32 * wn + 16 * np +
                              (mat >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A = (w⊙x)ᵀ, p rows and j columns, hi then lo
        const int off = (k0 + r8 + (mat >> 1) * 8) * ldp + 32 * wm + 16 * mi + (mat & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, wxh + off);
        ldsm_x4_t(al, wxl + off);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], ah, bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
          mma_bf16(acc[mi][ni], al, bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
        }
      }
    }
    float* dst = states + (((size_t)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int p = 32 * wm + 16 * mi + g4, n = 32 * wn + 8 * ni + 2 * t4;
        *reinterpret_cast<float2*>(dst + (size_t)p * N + n) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(dst + (size_t)(p + 8) * N + n) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
}

// 2. the state pass: chunk states → entering states, in place; final state
__global__ void __launch_bounds__(kThreads) ssd_state_pass(
    float* __restrict__ states, const float* __restrict__ decay,
    const float* __restrict__ init, float* __restrict__ final_state, int nc, int H, int PN) {
  const int b = blockIdx.y;
  const size_t per_b = (size_t)H * PN;                 // floats of one (b, chunk)
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= per_b) return;
  const int h = (int)(i / PN);
  float4 st = init ? *reinterpret_cast<const float4*>(init + b * per_b + i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* p = reinterpret_cast<float4*>(states + (size_t)b * nc * per_b + i);
  const float* dc = decay + (size_t)b * nc * H + h;
  const size_t step = per_b / 4;
  float4 next = p[0];
  for (int c = 0; c < nc; ++c) {
    const float4 s_c = next;
    if (c + 1 < nc) next = p[(c + 1) * step];
    const float d = dc[(size_t)c * H];
    p[c * step] = st;
    st = make_float4(d * st.x + s_c.x, d * st.y + s_c.y, d * st.z + s_c.z, d * st.w + s_c.w);
  }
  *reinterpret_cast<float4*>(final_state + b * per_b + i) = st;
}

struct OutputSmem {                    // byte offsets of pass 3's shared memory
  size_t cum_hi, cum_lo, dts, cb, cs, s_hi, s_lo, xs, sf, sf_buf, bytes;
  __host__ __device__ OutputSmem(int P, int N, int Q, int HT) {
    const int nrb = Q / 16;
    const size_t row_n = (size_t)(N + kPad) * 2, row_p = (size_t)(P + kPad) * 2;
    cum_hi = 0;                                          // f32 [HT][Q]: cum as hi + lo
    cum_lo = cum_hi + (size_t)HT * Q * 4;
    dts = cum_lo + (size_t)HT * Q * 4;                   // f32 [HT][Q]
    cb = dts + (size_t)HT * Q * 4;                       // f32 [nrb(nrb+1)/2][256]
    cs = cb + (size_t)nrb * (nrb + 1) / 2 * 256 * 4;     // bf16 [Q][N + kPad]  C
    s_hi = cs + Q * row_n;                               // bf16 [P][N + kPad]  S_in hi
    s_lo = s_hi + P * row_n;                             //                     and lo
    const size_t b_end = s_hi + Q * row_n;               // the B chunk, first, over S_in
    xs = (b_end > s_lo + P * row_n ? b_end : s_lo + P * row_n);   // bf16 [2][Q][P + kPad]
    // two buffers, each f32 [P][N] S_in as loaded, then bf16 [Q][P + kPad] y
    sf = xs + 2 * Q * row_p;
    sf_buf = (size_t)P * N * 4 > Q * row_p ? (size_t)P * N * 4 : Q * row_p;
    bytes = sf + 2 * sf_buf;
  }
};

// 3. y per (chunk, b, head): exp(cum_i)·C·S_inᵀ + (C·Bᵀ ⊙ decay ⊙ dt)·x + D·x
__global__ void __launch_bounds__(kThreads, 1) ssd_output_mma(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dp,
    const float* __restrict__ states, bf16* __restrict__ y, int S, int H, int G, int P,
    int N, int Q, int HT) {
  extern __shared__ float4 smem_output[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_output);
  const OutputSmem L(P, N, Q, HT);
  const int ldn = N + kPad, ldp = P + kPad;
  float* cum_hi = reinterpret_cast<float*>(base + L.cum_hi);
  float* cum_lo = reinterpret_cast<float*>(base + L.cum_lo);
  float* dts = reinterpret_cast<float*>(base + L.dts);
  float* cb = reinterpret_cast<float*>(base + L.cb);
  bf16* cs = reinterpret_cast<bf16*>(base + L.cs);
  bf16* bs = reinterpret_cast<bf16*>(base + L.s_hi);
  bf16* shi = bs;
  bf16* slo = reinterpret_cast<bf16*>(base + L.s_lo);

  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  int g, h0;
  head_tile(H, G, HT, g, h0);
  const int s0 = c * Q, nval = min(Q, S - s0), nrb = Q / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, r8 = lane & 7, g4 = lane >> 2, t4 = lane & 3;

  // x and S_in of head tile hh into buffer hh % 2, asynchronously
  auto fetch = [&](int hh) {
    const int h = h0 + hh;
    bf16* xd = reinterpret_cast<bf16*>(base + L.xs) + (hh & 1) * Q * ldp;
    copy_rows(xd, ldp, x + (((size_t)b * S + s0) * H + h) * P, (size_t)H * P, Q, nval, P);
    float* sd = reinterpret_cast<float*>(base + L.sf + (hh & 1) * L.sf_buf);
    const float* src = states + (((size_t)b * nc + c) * H + h) * P * N;
    for (int i = tid; i < P * N / 4; i += kThreads) cp_async16(sd + 4 * i, src + 4 * i, true);
    cp_async_commit();
  };

  const size_t bc_off = (((size_t)b * S + s0) * G + g) * N;
  copy_rows(cs, ldn, Cm + bc_off, (size_t)G * N, Q, nval, N);
  copy_rows(bs, ldn, Bm + bc_off, (size_t)G * N, Q, nval, N);
  cp_async_commit();
  fetch(0);
  for (int i = tid; i < HT * Q; i += kThreads) {
    const int hh = i / Q, j = i - hh * Q;
    dts[i] = j < nval ? dt[((size_t)b * S + s0 + j) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  for (int hh = warp; hh < HT; hh += kThreads / 32) {   // cum in f64, kept as f32 hi + lo
    double cv[kMaxQ / 32];
    const int per = Q / 32;
    warp_cum(dts + hh * Q, -expf(A_log[h0 + hh]), per, lane, cv);
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e) {
      if (e < per) {
        const float hi = (float)cv[e];
        cum_hi[hh * Q + lane * per + e] = hi;
        cum_lo[hh * Q + lane * per + e] = (float)(cv[e] - (double)hi);
      }
    }
  }
  cp_async_wait<1>();                  // C and B have landed
  __syncthreads();
  // C·Bᵀ for the 16x16 blocks (ib, jb ≤ ib), warp ib; stored in fragment order
  if (warp < nrb) {
    for (int jb = 0; jb <= warp; ++jb) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, cs + (16 * warp + r8 + (mat & 1) * 8) * ldn + k0 + (mat >> 1) * 8);
        ldsm_x4(bb, bs + (16 * jb + r8 + (mat >> 1) * 8) * ldn + k0 + (mat & 1) * 8);
        mma_bf16(acc[0], a, bb[0], bb[1]);
        mma_bf16(acc[1], a, bb[2], bb[3]);
      }
      float4* dst = reinterpret_cast<float4*>(cb + (warp * (warp + 1) / 2 + jb) * 256) + lane * 2;
      dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
  }

  // warp (k, half): row blocks k and nrb − 1 − k (the causal work of the pair
  // is balanced), columns p of one half of P
  const int pair = warp >> 1, p0 = 32 * (warp & 1);
  const bool active = pair < nrb / 2 && p0 < P;
  const int rb[2] = {pair, nrb - 1 - pair};
  for (int hh = 0; hh < HT; ++hh) {
    __syncthreads();                   // head hh - 1 is done with the buffers (and B)
    if (hh + 1 < HT) {
      fetch(hh + 1);                   // overlaps head hh
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // head hh's x and S_in have landed
    const int h = h0 + hh;
    const bf16* xs = reinterpret_cast<const bf16*>(base + L.xs) + (hh & 1) * Q * ldp;
    const float* sf = reinterpret_cast<const float*>(base + L.sf + (hh & 1) * L.sf_buf);
    for (int i = tid; i < P * N / 4; i += kThreads) {   // S_in as bf16 hi + lo
      const int p = i / (N / 4), e = (i - p * (N / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(sf + 4 * i);
      uint2 hi, lo;
      split_bf16(v.x, v.y, hi.x, lo.x);
      split_bf16(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(shi + p * ldn + e) = hi;
      *reinterpret_cast<uint2*>(slo + p * ldn + e) = lo;
    }
    __syncthreads();
    // y is staged in the converted S_in's buffer (sized for either), then
    // stored in 16-byte rows
    bf16* ys = reinterpret_cast<bf16*>(base + L.sf + (hh & 1) * L.sf_buf);
    if (active) {
      const float* chi = cum_hi + hh * Q;
      const float* clo = cum_lo + hh * Q;
      const float* dth = dts + hh * Q;
      float acc[2][4][4];                // [row block][n8 block of the half][fragment]
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][nb][e] = 0.f;
      // inter: C·S_inᵀ with S_in as hi + lo
      for (int k = 0; k < N; k += 16) {
        uint32_t a[2][4], bh[2][4], bl[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          ldsm_x4(a[r], cs + (16 * rb[r] + r8 + (mat & 1) * 8) * ldn + k + (mat >> 1) * 8);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int off = (p0 + 16 * pp + r8 + (mat >> 1) * 8) * ldn + k + (mat & 1) * 8;
          ldsm_x4(bh[pp], shi + off);
          ldsm_x4(bl[pp], slo + off);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            mma_bf16(acc[r][2 * pp], a[r], bh[pp][0], bh[pp][1]);
            mma_bf16(acc[r][2 * pp + 1], a[r], bh[pp][2], bh[pp][3]);
            mma_bf16(acc[r][2 * pp], a[r], bl[pp][0], bl[pp][1]);
            mma_bf16(acc[r][2 * pp + 1], a[r], bl[pp][2], bl[pp][3]);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ia = 16 * rb[r] + g4;  // rows ia and ia + 8
        const float hia = chi[ia], loa = clo[ia], hib = chi[ia + 8], lob = clo[ia + 8];
        const float ea = ex2(hia * kLog2e), eb = ex2(hib * kLog2e);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          acc[r][nb][0] *= ea;
          acc[r][nb][1] *= ea;
          acc[r][nb][2] *= eb;
          acc[r][nb][3] *= eb;
        }
        // intra: att = C·Bᵀ ⊙ exp(cum_i − cum_j) ⊙ dt_j, as bf16 hi + lo
        for (int jb = 0; jb <= rb[r]; ++jb) {
          const float4* src = reinterpret_cast<const float4*>(
                                  cb + (rb[r] * (rb[r] + 1) / 2 + jb) * 256) + lane * 2;
          const float4 f0 = src[0], f1 = src[1];
          float v[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
          for (int u = 0; u < 2; ++u) {  // v[4u..]: (ia, j), (ia, j+1), (ia+8, j), (ia+8, j+1)
            const int j = 16 * jb + 8 * u + 2 * t4;
            const float2 cj = *reinterpret_cast<const float2*>(chi + j);
            const float2 lj = *reinterpret_cast<const float2*>(clo + j);
            const float2 dj = *reinterpret_cast<const float2*>(dth + j);
            v[4 * u] *= decay_dt(ia, j, hia, loa, cj.x, lj.x, dj.x);
            v[4 * u + 1] *= decay_dt(ia, j + 1, hia, loa, cj.y, lj.y, dj.y);
            v[4 * u + 2] *= decay_dt(ia + 8, j, hib, lob, cj.x, lj.x, dj.x);
            v[4 * u + 3] *= decay_dt(ia + 8, j + 1, hib, lob, cj.y, lj.y, dj.y);
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_bf16(v[2 * q], v[2 * q + 1], ah[q], al[q]);
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            uint32_t bx[4];
            ldsm_x4_t(bx, xs + (16 * jb + r8 + (mat & 1) * 8) * ldp + p0 + 16 * pp +
                              (mat >> 1) * 8);
            mma_bf16(acc[r][2 * pp], ah, bx[0], bx[1]);
            mma_bf16(acc[r][2 * pp + 1], ah, bx[2], bx[3]);
            mma_bf16(acc[r][2 * pp], al, bx[0], bx[1]);
            mma_bf16(acc[r][2 * pp + 1], al, bx[2], bx[3]);
          }
        }
      }
      const float Dh = Dp[h];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int p = p0 + 8 * nb + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 16 * rb[r] + g4 + 8 * half;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + i * ldp + p));
            *reinterpret_cast<uint32_t*>(ys + i * ldp + p) = pack_bf16(
                acc[r][nb][2 * half] + Dh * xv.x, acc[r][nb][2 * half + 1] + Dh * xv.y);
          }
        }
      }
    }
    __syncthreads();
    const int p8 = P / 8;
    for (int i = tid; i < nval * p8; i += kThreads) {
      const int j = i / p8, e = (i - j * p8) * 8;
      *reinterpret_cast<uint4*>(y + (((size_t)b * S + s0 + j) * H + h) * P + e) =
          *reinterpret_cast<const uint4*>(ys + j * ldp + e);
    }
  }
}

bool shapes_ok(int S, int H, int G, int P, int N, int Q) {
  return !(P % 32 || P > kMaxP || N % 32 || N > kMaxN || Q % 32 || Q > kMaxQ || G < 1 ||
           H % G || S < 1);
}

// Heads per block: the largest power of two up to most that divides H / G.
int heads_per_tile(int H, int G, int most) {
  int ht = most;
  while ((H / G) % ht) ht /= 2;
  return ht;
}

template <bool kBwd>
int launch_states(const void* x, const void* dt, const void* A_log, const void* Bm,
                  void* states, void* decay, int Bb, int S, int H, int G, int P, int N,
                  int Q, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  const int HT = heads_per_tile(H, G, 4);
  const size_t smem = states_smem(P, N, Q, HT);
  cudaError_t e = cudaFuncSetAttribute(ssd_states_mma<kBwd>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + Q - 1) / Q, Bb, H / HT);
  ssd_states_mma<kBwd><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<float*>(states), static_cast<float*>(decay), S, H, G, P, N, Q, HT);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward (the port of JAX's autodiff through ssd_jnp.ssd_chunked,
// src/repro/kernels/ssd_jnp.py:31). With S_in[c] the state entering chunk c
// and dS[c] the gradient of the state leaving it (dS[nc-1] = d final):
//   dS[c-1] = exp(seg_c)·dS[c] + Σ_i exp(cum_i)·dy_i ⊗ C_i,  d init = dS[-1]
// and per chunk, with e_ij = exp(cum_i − cum_j) masked to i ≥ j before exp:
//   dx_j  = Σ_i (C_i·B_j)·e_ij·dt_j·dy_i + w_j·dS·B_j + D·dy_j
//   dB_j  = Σ_i e_ij·dt_j·(dy_i·x_j)·C_i + w_j·x_jᵀ·dS           (w_j = exp(seg − cum_j)·dt_j)
//   dC_i  = Σ_j e_ij·dt_j·(dy_i·x_j)·B_j + exp(cum_i)·dy_iᵀ·S_in
//   ddt_j = Σ_i (C_i·B_j)·e_ij·(dy_i·x_j) + exp(seg − cum_j)·x_jᵀ·dS·B_j + A·d(dt·A)_j
// where d(dt·A) is the reverse in-chunk cumsum of d cum, which collects the
// derivative of every exponential (intra at i and −j, inter, carry, and
// exp(seg)·⟨dS, S_in⟩ at the chunk's last step). dB and dC are summed over
// the heads of a group, dA_log and dD over b and chunks, in a fixed order:
// no float atomics, so a call repeats bit for bit.
//
// Launches (bwd_launches in ssd_scan.py): the forward's chunk states and
// pass recomputed (S_in per chunk, ~0.2 ms a mamba2 layer against 3.2 GB
// to keep them for 48 layers); ssd_states_mma<true> for the chunks'
// Σ exp(cum_i)·dy_i ⊗ C_i; ssd_dstate_pass, the reverse walk over chunks
// (in place: slot c gets dS[c]); the chunk kernel, writing dx, ddt, dB / dC
// partials and per-chunk dA / dD partials; ssd_bwd_finish, the fixed-order
// sums of the partials.
// Bound on the H100 in bf16 at mamba2's training microbatch (2, 2048, 64,
// 64, G 1, N 128, Q 128): operations, 3.9e10 (~2.6x the forward's per
// token: C·Bᵀ, dy·xᵀ and three intra products over the causal pairs, and
// five Q·N·P products), 0.039 ms at 989 TFLOP/s; bytes read x, dt, B, C,
// dy and write dx, ddt, dB, dC once.
//
// bf16 chunk kernel (ssd_bwd_tile_mma): one block of 8 warps per (chunk, b,
// group x tile of HT heads), HT from ssd_scan.bwd_heads_per_tile (8 for
// mamba2: 256 blocks, two waves on 132 SMs; 5 for zamba2's 80 heads); the
// last tile of a group may be short (H / G = 12 with HT 8 gives 8 + 4).
// What the heads of a group share is computed once per block:
//  - C·Bᵀ for the causal 16x16 blocks (mma.sync, f32, in shared memory in
//    fragment order), reused by every head of the tile;
//  - dB and dC's intra terms by one identity. With M^h_ij = e^h_ij·dt^h_j·
//    (dy^h_i·x^h_j), masked to i ≥ j, dB_intra_j = Σ_i (Σ_h M^h_ij)·C_i and
//    dC_intra_i = Σ_j (Σ_h M^h_ij)·B_j: each head adds its M to Σ M (f32,
//    shared memory, fragment order, each block owned by one warp), and two
//    products per tile follow the last head (Σ Mᵀ as A fragments for dB; for
//    dC the same blocks transposed in registers with movmatrix).
// Per head, warp w owns row block w (as rows j of dx and dB, rows i of dC):
//  - dy·xᵀ once per block i ≥ j (x_j·dy_iᵀ on mma.sync), used for Σ M, the
//    T_ij sums of d cum in both orientations (rows from registers, columns
//    through f64 partials per row block summed in order) and dx's intra term
//    G = (C_i·B_j)·e_ij·dt_j into dy (G as bf16 hi + lo A fragments);
//  - the products with dS and S_in on wgmma (RS: A = B, x or dy rows from
//    registers; B = the state, bf16 hi + lo in 128-byte-swizzled boxes):
//    dx's carry w_j·B_j·dSᵀ (K-major B), dB's carry w_j·x_jᵀ·dS and dC's
//    inter exp(cum_i)·dy_i·S_in (MN-major B, 64 state columns a product).
//    dB sums over the tile's heads in registers; dC in its partial in device
//    memory, which each thread alone reads back and adds to (registers
//    for both spilled ~500 bytes and ran 10% slower on the card);
//  - dS, then S_in, arrive as raw f32 by one bulk copy each (an mbarrier),
//    S_in while the intra terms run, the next head's dS, x and dy while the
//    last phase and the end of the chunk run; each is converted in place to
//    the hi + lo boxes. The last warp (the least intra work) scans the next
//    head's cum meanwhile; the end of the chunk (d cum's reverse cumsum,
//    ddt, dA) runs on Q threads.
//  Partials are (B, S, G x tiles, N): ssd_bwd_finish reads HT times fewer
//  bytes than with a partial per head.
// Rounding points, as the per-head kernel: x, B, C, dy are bf16; every f32
// operand (G, Σ M, dS, S_in) enters as a bf16 hi + lo pair; products
// accumulate in f32; cum is scanned in f64 and kept as an f32 hi + lo pair;
// the T_ij sums are f64; every exponent is masked before exp. Σ M is summed
// in f32 before its hi + lo split, where the per-head kernel split each
// head's M.
// ptxas (sm_90a, -O3): ssd_bwd_tile_mma 255 registers, 112 bytes of spill
// stores (the dB accumulators, live across the head loop, are 64 registers);
// 231,176 bytes of shared memory at (64, 128, 128), one block per SM.
// Where a head's time goes (NVIDIA H100 80GB HBM3, clock64 stamps of one
// block, ~47k cycles a head): warp 0's intra loop ~16k (8 column blocks;
// warp 7 has 1; the f64 column sums were 4k of it before their shuffles
// became a reduce-scatter), the dC phase ~8k, the conversions and waits
// the rest. Handing the heavy warps' blocks to light ones through slots in
// C's buffer (C brought back by bulk copies) balanced the loop but ran
// 0.534 ms against 0.438: the slots, the extra barrier and the registers
// cost more than the imbalance.
//
// The earlier chunk kernel (ssd_bwd_mma, on no path; _ssd_scan_bwd_per_head
// in ssd_scan.py times it), one block per (chunk, b, head), 8 warps, 183 KB
// of shared memory at (64, 128, 128), ptxas 187 registers, no spills: warp
// w owns the 16 rows of block w twice. As rows j it computes (B·Cᵀ) and
// (x·dyᵀ) for the column blocks i ≥ j on mma.sync, forms e·dt·(C·B) and
// e·dt·(dy·x) in registers (the f32 C fragment of m16n8 is the A fragment
// of k16) and multiplies them into dy (→ dx) and C (→ dB); as rows i, (C·Bᵀ)
// and (dy·xᵀ) for j ≤ i, into B (→ dC). Warp w has nrb − w column blocks
// and w + 1 row blocks: the same work for every warp, at the price of C·Bᵀ
// and dy·xᵀ computed twice. The carry terms are products with dS and S_in
// (dS·Bᵀ, x·dS, dy·S_in). It writes dB / dC partials per head (B, S, H, N).
// The f32 instance (ssd_states_f64, ssd_walk_f64, ssd_bwd_cuda_cores) runs the
// same steps on the CUDA cores in f64, for the 1e-4 check (see below why).

// The sum of v over the block, in a fixed order; every thread gets it.
// ``red`` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum_f32(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// The per-row vectors both chunk kernels fill, [Q] each: dt; the intra
// terms' share of d cum at i (trow_i = Σ_j T_ij) and at j (tcol_j =
// Σ_i T_ij, entering with a minus), in f64; the direct part of ddt; the
// inter terms U_i and the carry terms V_j. Each intra pair enters d cum
// twice with opposite signs, and the reverse cumsum of d cum cancels every
// pair that lies on one side of a step: the same f32 T_ij is summed both
// times and the sums are f64, so the cancellation is exact and only the
// pairs that cross the step remain (f32 sums leave their rounding there,
// which at mamba2's decays is larger than what remains).
struct BwdRows {
  float* dts;
  double *trow, *tcol, *ddt_dir, *us, *vs;
};

// BwdRows in ``base``: five f64 vectors of Q, then dt; 16-byte aligned.
__host__ __device__ inline size_t bwd_rows_bytes(int Q) { return (size_t)Q * 44; }
__device__ __forceinline__ BwdRows bwd_rows(void* base, int Q) {
  double* d = reinterpret_cast<double*>(base);
  return BwdRows{reinterpret_cast<float*>(d + 5 * Q), d, d + Q, d + 2 * Q, d + 3 * Q,
                 d + 4 * Q};
}

// The sum of v over the block in f64, in a fixed order (as block_sum_f32)
__device__ __forceinline__ double block_sum_f64(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// The end of a chunk, by warp 0: d cum (with d seg = Σ V_j + exp(seg)·⟨dS,
// S_in⟩ at the last step), its reverse cumsum d(dt·A) in f64, ddt for the
// valid steps, and this chunk's dA = Σ dt·d(dt·A) and dD partials.
__device__ __forceinline__ void bwd_chunk_tail(const BwdRows& r, int Q, int nval, float A,
                                               double eseg_dot, double dD_sum, float* ddt,
                                               size_t ddt_row0, int H, double* dA_part,
                                               double* dD_part, size_t part) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, per = Q / 32;
  double vsum = 0.0;
  for (int e = 0; e < per; ++e) vsum += (double)r.vs[lane * per + e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vsum += __shfl_xor_sync(0xffffffffu, vsum, o);
  const double dseg = vsum + eseg_dot;
  double suf[kMaxQ / 32];
  double run = 0.0;
#pragma unroll
  for (int e = kMaxQ / 32 - 1; e >= 0; --e) {
    if (e < per) {
      const int t = lane * per + e;
      run += r.trow[t] - r.tcol[t] + r.us[t] - r.vs[t] + (t == Q - 1 ? dseg : 0.0);
      suf[e] = run;
    }
  }
  double incl = run;                   // suffix sums over lanes >= this one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += t;
  }
  double excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.0;
  double da = 0.0;
#pragma unroll
  for (int e = 0; e < kMaxQ / 32; ++e) {
    if (e < per) {
      const int t = lane * per + e;
      const double dla = suf[e] + excl;
      da += (double)r.dts[t] * dla;
      if (t < nval) ddt[ddt_row0 + (size_t)t * H] = (float)(r.ddt_dir[t] + (double)A * dla);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) {
    dA_part[part] = da;
    dD_part[part] = dD_sum;
  }
}

// The reverse pass over chunks, in place: slot c of dstates holds Σ_i
// exp(cum_i)·dy_i ⊗ C_i of chunk c on entry and dS[c], the gradient of the
// state leaving chunk c, on exit; dinit (unless NULL) gets the gradient of
// the initial state. dfinal may be NULL (a zero gradient).
__global__ void __launch_bounds__(kThreads) ssd_dstate_pass(
    float* __restrict__ dstates, const float* __restrict__ decay,
    const float* __restrict__ dfinal, float* __restrict__ dinit, int nc, int H, int PN) {
  const int b = blockIdx.y;
  const size_t per_b = (size_t)H * PN;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= per_b) return;
  const int h = (int)(i / PN);
  float4 g = dfinal ? *reinterpret_cast<const float4*>(dfinal + b * per_b + i)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* p = reinterpret_cast<float4*>(dstates + (size_t)b * nc * per_b + i);
  const float* dc = decay + (size_t)b * nc * H + h;
  const size_t step = per_b / 4;
  float4 next = p[(size_t)(nc - 1) * step];
  for (int c = nc - 1; c >= 0; --c) {
    const float4 ds = next;
    if (c > 0) next = p[(size_t)(c - 1) * step];
    const float d = dc[(size_t)c * H];
    p[(size_t)c * step] = g;
    g = make_float4(d * g.x + ds.x, d * g.y + ds.y, d * g.z + ds.z, d * g.w + ds.w);
  }
  if (dinit) *reinterpret_cast<float4*>(dinit + b * per_b + i) = g;
}

struct BwdSmem {                       // byte offsets of ssd_bwd_mma's shared memory
  size_t xs, dys, bs, cs, s_hi, s_lo, d_hi, d_lo, cum_hi, cum_lo, rows, red, bytes;
  __host__ __device__ BwdSmem(int P, int N, int Q) {
    const size_t row_p = (size_t)(P + kPad) * 2, row_n = (size_t)(N + kPad) * 2;
    xs = 0;                                  // bf16 [Q][P + kPad]  x
    dys = xs + Q * row_p;                    //                     dy
    bs = dys + Q * row_p;                    // bf16 [Q][N + kPad]  B
    cs = bs + Q * row_n;                     //                     C
    s_hi = cs + Q * row_n;                   // bf16 [P][N + kPad]  S_in hi, lo
    s_lo = s_hi + P * row_n;
    d_hi = s_lo + P * row_n;                 //                     dS hi, lo
    d_lo = d_hi + P * row_n;
    cum_hi = d_lo + P * row_n;               // f32 [Q] each: cum hi, lo
    cum_lo = cum_hi + (size_t)Q * 4;
    rows = cum_lo + (size_t)Q * 4;           // BwdRows
    red = rows + bwd_rows_bytes(Q);          // f32 [kThreads / 32]
    bytes = red + kThreads / 32 * 4;
  }
};

// e_ij·v masked to i ≥ j before the exp, cum_i − cum_j from hi + lo pairs
__device__ __forceinline__ float masked_decay(int i, int j, float hi_i, float lo_i,
                                              float hi_j, float lo_j) {
  return ex2(kLog2e * (j <= i ? (hi_i - hi_j) + (lo_i - lo_j) : -INFINITY));
}

// (8 f32 values of a 16x16 C-fragment pair) → A fragment as bf16 hi + lo
__device__ __forceinline__ void frag_hi_lo(const float (&v)[8], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_bf16(v[2 * q], v[2 * q + 1], hi[q], lo[q]);
}

// acc (16 x 16) = rows [r0, r0+16) of A (row-major, lda) times rows
// [c0, c0+16) of Bt (row-major, ldb), both bf16 over k in [0, K): A·Btᵀ
__device__ __forceinline__ void mma_abt(float (&acc)[2][4], const bf16* A, int lda, int r0,
                                        const bf16* Bt, int ldb, int c0, int K, int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4], bb[4];
    ldsm_x4(a, A + (r0 + r8 + (mat & 1) * 8) * lda + k0 + (mat >> 1) * 8);
    ldsm_x4(bb, Bt + (c0 + r8 + (mat >> 1) * 8) * ldb + k0 + (mat & 1) * 8);
    mma_bf16(acc[0], a, bb[0], bb[1]);
    mma_bf16(acc[1], a, bb[2], bb[3]);
  }
}

// acc[nt] (16 x 8 each, nt < W / 8 <= NT) += A fragment (hi + lo) · rows
// [k0, k0+16) of M (row-major [k][n], ld), the n columns [0, W)
template <int NT>
__device__ __forceinline__ void mma_frag_rows(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const bf16* M, int ld,
                                              int k0, int W, int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (16 * np < W) {
      uint32_t bx[4];
      ldsm_x4_t(bx, M + (k0 + r8 + (mat & 1) * 8) * ld + 16 * np + (mat >> 1) * 8);
      mma_bf16(acc[2 * np], ah, bx[0], bx[1]);
      mma_bf16(acc[2 * np + 1], ah, bx[2], bx[3]);
      mma_bf16(acc[2 * np], al, bx[0], bx[1]);
      mma_bf16(acc[2 * np + 1], al, bx[2], bx[3]);
    }
  }
}

// acc[nt] += rows [r0, r0+16) of A (bf16 row-major [r][k], lda) · (Mh + Ml)
// over k in [0, K), M row-major [k][n] with n in [0, W); trans: M is [n][k]
template <int NT>
__device__ __forceinline__ void mma_rows_hilo(float (&acc)[NT][4], const bf16* A, int lda,
                                              int r0, const bf16* Mh, const bf16* Ml, int ld,
                                              int K, int W, bool trans, int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (r0 + r8 + (mat & 1) * 8) * lda + k0 + (mat >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (16 * np < W) {
        uint32_t bh[4], bl[4];
        if (trans) {                   // M [n][k]: the B fragment without a transpose
          const int off = (16 * np + r8 + (mat >> 1) * 8) * ld + k0 + (mat & 1) * 8;
          ldsm_x4(bh, Mh + off);
          ldsm_x4(bl, Ml + off);
        } else {
          const int off = (k0 + r8 + (mat & 1) * 8) * ld + 16 * np + (mat >> 1) * 8;
          ldsm_x4_t(bh, Mh + off);
          ldsm_x4_t(bl, Ml + off);
        }
        mma_bf16(acc[2 * np], a, bh[0], bh[1]);
        mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
        mma_bf16(acc[2 * np], a, bl[0], bl[1]);
        mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
      }
    }
  }
}

// Σ over this lane's columns of a 16 x W fragment row pair (rows g4 and
// g4 + 8) times bf16 row vectors va / vb, summed over the quad.
template <int NT>
__device__ __forceinline__ void frag_row_dots(const float (&acc)[NT][4], const bf16* va,
                                              const bf16* vb, int W, int t4, float& sa,
                                              float& sb) {
  sa = 0.f;
  sb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (8 * nt < W) {
      const int n = 8 * nt + 2 * t4;
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(va + n));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vb + n));
      sa += acc[nt][0] * a.x + acc[nt][1] * a.y;
      sb += acc[nt][2] * b.x + acc[nt][3] * b.y;
    }
  }
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sa += __shfl_xor_sync(0xffffffffu, sa, 2);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 2);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], float sa, float sb) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] *= sa;
    acc[nt][1] *= sa;
    acc[nt][2] *= sb;
    acc[nt][3] *= sb;
  }
}

// rows ra and ra + 8 (if < nval) of a 16 x W f32 fragment into out (f32,
// row stride ld)
template <int NT>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[NT][4], float* out,
                                               size_t ld, int ra, int nval, int W, int t4) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (8 * nt < W) {
      const int n = 8 * nt + 2 * t4;
      if (ra < nval)
        *reinterpret_cast<float2*>(out + ra * ld + n) = make_float2(acc[nt][0], acc[nt][1]);
      if (ra + 8 < nval)
        *reinterpret_cast<float2*>(out + (ra + 8) * ld + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// The bf16 chunk kernel, one block per (chunk, b, head).
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_mma(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dp, const bf16* __restrict__ dy,
    const float* __restrict__ s_in, const float* __restrict__ ds_out,
    bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
    float* __restrict__ dC_part, double* __restrict__ dA_part, double* __restrict__ dD_part,
    int S, int H, int G, int P, int N, int Q) {
  extern __shared__ float4 smem_bwd[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_bwd);
  const BwdSmem L(P, N, Q);
  const int ldp = P + kPad, ldn = N + kPad;
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);
  bf16* dys = reinterpret_cast<bf16*>(base + L.dys);
  bf16* bs = reinterpret_cast<bf16*>(base + L.bs);
  bf16* cs = reinterpret_cast<bf16*>(base + L.cs);
  bf16* s_hi = reinterpret_cast<bf16*>(base + L.s_hi);
  bf16* s_lo = reinterpret_cast<bf16*>(base + L.s_lo);
  bf16* d_hi = reinterpret_cast<bf16*>(base + L.d_hi);
  bf16* d_lo = reinterpret_cast<bf16*>(base + L.d_lo);
  float* cum_hi = reinterpret_cast<float*>(base + L.cum_hi);
  float* cum_lo = reinterpret_cast<float*>(base + L.cum_lo);
  const BwdRows R = bwd_rows(base + L.rows, Q);
  float* red = reinterpret_cast<float*>(base + L.red);

  const int c = blockIdx.x, b = blockIdx.y, h = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q, nval = min(Q, S - s0), nrb = Q / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;

  const size_t xo = (((size_t)b * S + s0) * H + h) * P;
  const size_t bo = (((size_t)b * S + s0) * G + g) * N;
  copy_rows(xs, ldp, x + xo, (size_t)H * P, Q, nval, P);
  copy_rows(dys, ldp, dy + xo, (size_t)H * P, Q, nval, P);
  copy_rows(bs, ldn, Bm + bo, (size_t)G * N, Q, nval, N);
  copy_rows(cs, ldn, Cm + bo, (size_t)G * N, Q, nval, N);
  cp_async_commit();
  const size_t so = (((size_t)b * nc + c) * H + h) * P * N;
  float dot = 0.f;                     // ⟨dS, S_in⟩
  for (int i = tid; i < P * N / 4; i += kThreads) {
    const int p = i / (N / 4), e = (i - p * (N / 4)) * 4;
    const float4 sv = *reinterpret_cast<const float4*>(s_in + so + 4 * (size_t)i);
    const float4 dv = *reinterpret_cast<const float4*>(ds_out + so + 4 * (size_t)i);
    dot += dv.x * sv.x + dv.y * sv.y + dv.z * sv.z + dv.w * sv.w;
    uint2 hi, lo;
    split_bf16(sv.x, sv.y, hi.x, lo.x);
    split_bf16(sv.z, sv.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(s_hi + p * ldn + e) = hi;
    *reinterpret_cast<uint2*>(s_lo + p * ldn + e) = lo;
    split_bf16(dv.x, dv.y, hi.x, lo.x);
    split_bf16(dv.z, dv.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(d_hi + p * ldn + e) = hi;
    *reinterpret_cast<uint2*>(d_lo + p * ldn + e) = lo;
  }
  for (int i = tid; i < Q; i += kThreads)
    R.dts[i] = i < nval ? dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
  __syncthreads();
  const float A = -expf(A_log[h]);
  if (warp == 0) {
    double cv[kMaxQ / 32];
    const int per = Q / 32;
    warp_cum(R.dts, A, per, lane, cv);
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e) {
      if (e < per) {
        const float hi = (float)cv[e];
        cum_hi[lane * per + e] = hi;
        cum_lo[lane * per + e] = (float)(cv[e] - (double)hi);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const float dot_all = block_sum_f32(dot, red);
  float dd = 0.f;                      // dD: Σ dy·x over the chunk
  for (int i = tid; i < nval * P / 2; i += kThreads) {
    const int j = i / (P / 2), p = (i - j * (P / 2)) * 2;
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + j * ldp + p));
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dys + j * ldp + p));
    dd += a.x * d.x + a.y * d.y;
  }
  const float dD_all = block_sum_f32(dd, red);
  const float seg_hi = cum_hi[Q - 1], seg_lo = cum_lo[Q - 1];

  if (warp < nrb) {
    const int r0 = 16 * warp, ra = r0 + g4, rb = ra + 8;
    const float hia = cum_hi[ra], loa = cum_lo[ra], hib = cum_hi[rb], lob = cum_lo[rb];
    float acc_p[kMaxP / 8][4], acc_n[kMaxN / 8][4];   // [n8 tile][fragment]: dx; dB, dC

    // ---- rows j: dx and dB ----
    {
      const float dta = R.dts[ra], dtb = R.dts[rb];
      const float era = ex2(kLog2e * ((seg_hi - hia) + (seg_lo - loa)));   // exp(seg − cum_j)
      const float erb = ex2(kLog2e * ((seg_hi - hib) + (seg_lo - lob)));
      // carry: dS·B_j (rows j, columns p); its dot with x_j
      zero_acc(acc_p);
      mma_rows_hilo(acc_p, bs, ldn, r0, d_hi, d_lo, ldn, N, P, true, lane);
      float xa, xb;
      frag_row_dots(acc_p, xs + ra * ldp, xs + rb * ldp, P, t4, xa, xb);
      scale_rows(acc_p, era * dta, erb * dtb);
      // carry: x_jᵀ·dS (rows j, columns n)
      zero_acc(acc_n);
      mma_rows_hilo(acc_n, xs, ldp, r0, d_hi, d_lo, ldn, P, N, false, lane);
      scale_rows(acc_n, era * dta, erb * dtb);
      // intra, column blocks i ≥ j: T_ij = (C_i·B_j)·e_ij·(dy_i·x_j)·dt_j
      float ta = 0.f, tb = 0.f;        // Σ_i T_ij / dt_j (the direct ddt)
      double Ta = 0.0, Tb = 0.0;       // Σ_i T_ij
      for (int ib = warp; ib < nrb; ++ib) {
        float cbt[2][4], dyx[2][4];
        mma_abt(cbt, bs, ldn, r0, cs, ldn, 16 * ib, N, lane);   // B_j·C_i
        mma_abt(dyx, xs, ldp, r0, dys, ldp, 16 * ib, P, lane);  // x_j·dy_i
        float gv[8], dv[8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 16 * ib + 8 * u + 2 * t4;
          const float2 hi = *reinterpret_cast<const float2*>(cum_hi + i);
          const float2 lo = *reinterpret_cast<const float2*>(cum_lo + i);
          const float e[4] = {masked_decay(i, ra, hi.x, lo.x, hia, loa),
                              masked_decay(i + 1, ra, hi.y, lo.y, hia, loa),
                              masked_decay(i, rb, hi.x, lo.x, hib, lob),
                              masked_decay(i + 1, rb, hi.y, lo.y, hib, lob)};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float dtj = q < 2 ? dta : dtb;
            const float ce = cbt[u][q] * e[q], t = ce * dyx[u][q];
            gv[4 * u + q] = ce * dtj;
            dv[4 * u + q] = e[q] * dtj * dyx[u][q];
            if (q < 2) {
              ta += t;
              Ta += (double)(t * dtj);
            } else {
              tb += t;
              Tb += (double)(t * dtj);
            }
          }
        }
        uint32_t gh[4], gl[4], dh[4], dl[4];
        frag_hi_lo(gv, gh, gl);
        frag_hi_lo(dv, dh, dl);
        mma_frag_rows(acc_p, gh, gl, dys, ldp, 16 * ib, P, lane);
        mma_frag_rows(acc_n, dh, dl, cs, ldn, 16 * ib, N, lane);
      }
      ta += __shfl_xor_sync(0xffffffffu, ta, 1);
      ta += __shfl_xor_sync(0xffffffffu, ta, 2);
      tb += __shfl_xor_sync(0xffffffffu, tb, 1);
      tb += __shfl_xor_sync(0xffffffffu, tb, 2);
      Ta += __shfl_xor_sync(0xffffffffu, Ta, 1);
      Ta += __shfl_xor_sync(0xffffffffu, Ta, 2);
      Tb += __shfl_xor_sync(0xffffffffu, Tb, 1);
      Tb += __shfl_xor_sync(0xffffffffu, Tb, 2);
      if (t4 == 0) {
        R.ddt_dir[ra] = ta + era * xa;
        R.ddt_dir[rb] = tb + erb * xb;
        R.tcol[ra] = Ta;
        R.tcol[rb] = Tb;
        R.vs[ra] = era * dta * xa;
        R.vs[rb] = erb * dtb * xb;
      }
      const float Dh = Dp[h];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (8 * nt < P) {
          const int p = 8 * nt + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = ra + 8 * half;
            if (j < nval) {
              const float2 d = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(dys + j * ldp + p));
              *reinterpret_cast<uint32_t*>(dx + xo + (size_t)j * H * P + p) =
                  pack_bf16(acc_p[nt][2 * half] + Dh * d.x, acc_p[nt][2 * half + 1] + Dh * d.y);
            }
          }
        }
      }
      store_rows_f32(acc_n, dB_part + (((size_t)b * S + s0) * H + h) * N, (size_t)H * N, ra,
                     nval, N, t4);
    }

    // ---- rows i: dC ----
    {
      const float eca = ex2(kLog2e * (hia + loa)), ecb = ex2(kLog2e * (hib + lob));
      zero_acc(acc_n);                 // inter: exp(cum_i)·dy_iᵀ·S_in, and its dot with C_i
      mma_rows_hilo(acc_n, dys, ldp, r0, s_hi, s_lo, ldn, P, N, false, lane);
      scale_rows(acc_n, eca, ecb);
      float ua, ub;
      frag_row_dots(acc_n, cs + ra * ldn, cs + rb * ldn, N, t4, ua, ub);
      double Ta = 0.0, Tb = 0.0;       // Σ_j T_ij, each T_ij as the columns form it
      for (int jb = 0; jb <= warp; ++jb) {
        float cb[2][4], dyx[2][4];
        mma_abt(cb, cs, ldn, r0, bs, ldn, 16 * jb, N, lane);    // C_i·B_j
        mma_abt(dyx, dys, ldp, r0, xs, ldp, 16 * jb, P, lane);  // dy_i·x_j
        float dv[8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 16 * jb + 8 * u + 2 * t4;
          const float2 hi = *reinterpret_cast<const float2*>(cum_hi + j);
          const float2 lo = *reinterpret_cast<const float2*>(cum_lo + j);
          const float2 dtj = *reinterpret_cast<const float2*>(R.dts + j);
          const float e[4] = {masked_decay(ra, j, hia, loa, hi.x, lo.x),
                              masked_decay(ra, j + 1, hia, loa, hi.y, lo.y),
                              masked_decay(rb, j, hib, lob, hi.x, lo.x),
                              masked_decay(rb, j + 1, hib, lob, hi.y, lo.y)};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float dt_q = q & 1 ? dtj.y : dtj.x;
            const float t = cb[u][q] * e[q] * dyx[u][q];
            dv[4 * u + q] = e[q] * dt_q * dyx[u][q];
            if (q < 2) Ta += (double)(t * dt_q); else Tb += (double)(t * dt_q);
          }
        }
        uint32_t dh[4], dl[4];
        frag_hi_lo(dv, dh, dl);
        mma_frag_rows(acc_n, dh, dl, bs, ldn, 16 * jb, N, lane);
      }
      Ta += __shfl_xor_sync(0xffffffffu, Ta, 1);
      Ta += __shfl_xor_sync(0xffffffffu, Ta, 2);
      Tb += __shfl_xor_sync(0xffffffffu, Tb, 1);
      Tb += __shfl_xor_sync(0xffffffffu, Tb, 2);
      if (t4 == 0) {
        R.trow[ra] = Ta;
        R.trow[rb] = Tb;
        R.us[ra] = ua;
        R.us[rb] = ub;
      }
      store_rows_f32(acc_n, dC_part + (((size_t)b * S + s0) * H + h) * N, (size_t)H * N, ra,
                     nval, N, t4);
    }
  }
  __syncthreads();
  const double eseg = exp((double)seg_hi + (double)seg_lo);
  bwd_chunk_tail(R, Q, nval, A, eseg * dot_all, dD_all, ddt, ((size_t)b * S + s0) * H + h, H,
                 dA_part, dD_part, ((size_t)b * nc + c) * H + h);
}

// ---- the bf16 chunk kernel by tiles of heads ----

constexpr int kLoads = 8;              // float4 loads a thread keeps in flight
constexpr int kBox = 64 * 128;         // bytes of a [64][64] bf16 box, 128-byte swizzle

// The sums of a and b over the block, in a fixed order (as block_sum_f32);
// ``red`` holds 2 · kThreads / 32 floats.
__device__ __forceinline__ void block_sum2_f32(float a, float b, float* red, float& sa,
                                               float& sb) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[(threadIdx.x >> 5) + (blockDim.x >> 5)] = b;
  }
  __syncthreads();
  sa = sb = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    sa += red[w];
    sb += red[w + (blockDim.x >> 5)];
  }
}

// Byte offsets of ssd_bwd_tile_mma's shared memory, from a 1024-byte aligned
// base. dS and then S_in of the current head share one hi + lo buffer, each
// [64 p][N] in boxes of 64 state columns, 128-byte swizzle (the wgmma B
// layout; rows p >= P and columns n >= N stay 0). x, dy, B and C are padded
// rows (ldmatrix) of at least 64 rows, the rows past Q zero. The B·Cᵀ
// blocks and Σ Mᵀ are kept in fragment order (rows j, columns i ≥ j; 256
// floats a 16x16 block, 8 a lane).
struct TileSmem {
  size_t s_hi, s_lo, xs, dys, bs, cs, cb, msum, cumx, rows, part_row, red2, red, bar, bytes;
  __host__ __device__ TileSmem(int P, int N, int Q) {
    const int QR = Q > 64 ? Q : 64, NB = (N + 63) / 64;
    const size_t row_p = (size_t)(P + kPad) * 2, row_n = (size_t)(N + kPad) * 2;
    const int nrb = Q / 16, blocks = nrb * (nrb + 1) / 2;
    s_hi = 0;                                // bf16 NB x [64][64]: dS, then S_in, hi
    s_lo = s_hi + (size_t)NB * kBox;         //                     and lo
    xs = s_lo + (size_t)NB * kBox;           // bf16 [QR][P + kPad]  x of the head
    dys = xs + QR * row_p;                   //                      dy
    bs = dys + QR * row_p;                   // bf16 [QR][N + kPad]  B
    cs = bs + QR * row_n;                    //                      C
    cb = cs + QR * row_n;                    // f32 [blocks][256]   B_j·C_i
    msum = cb + (size_t)blocks * 1024;       // f32 [blocks][256]   Σ_h M^h_ij (rows j)
    cumx = msum + (size_t)blocks * 1024;     // f32 [2][3][Q]: cum hi, lo and dt of a
                                             // head, two heads (this one, the next)
    rows = cumx + (size_t)6 * Q * 4;         // BwdRows (its dts unused: cumx has them)
    part_row = rows + bwd_rows_bytes(Q);     // f64 [nrb][Q]: Σ over a block's rows j of T_ij
    red2 = part_row + (size_t)nrb * Q * 8;   // f64 [3][kThreads / 32]
    red = red2 + 3 * kThreads / 32 * 8;      // f32 [2][kThreads / 32]
    bar = red + 2 * kThreads / 32 * 4;       // u64: the state copies' mbarrier
    bytes = bar + 8 + 1024;                  // + alignment
  }
};

// The byte offset of element (p, n) in NB boxes of [64][64] bf16, 128-byte
// swizzle: the 16-byte chunk n / 8 of row p sits at chunk (n / 8) ^ (p % 8).
__device__ __forceinline__ uint32_t sw128_at(int p, int n) {
  const int c = n & 63;
  return (uint32_t)((n >> 6) * kBox + p * 128 + ((((c >> 3) ^ (p & 7)) << 4) | ((c & 7) << 1)));
}

// d (64 x 64) += A (64 x 16, bf16 registers) · B (16 x 64, shared memory,
// K-major): the wgmma_m64n64_rs of hopper.cuh without trans-b.
__device__ __forceinline__ void wgmma_m64n64_rs_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The A fragments of rows [r0, r0 + 16) of a padded bf16 tile (lda), k16
// steps 0 .. steps − 1 (the mma.sync m16n8k16 A layout, which is wgmma's).
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KS][4], const bf16* A, int lda,
                                             int r0, int steps, int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < steps) ldsm_x4(a[kk], A + (r0 + r8 + (mat & 1) * 8) * lda + 16 * kk + (mat >> 1) * 8);
}

// d (64 rows of the warpgroup x 64) = A · (S_hi + S_lo) over its K steps on
// wgmma, A the fragments above. kmajor: B = Sᵀ (K = the state columns n, the
// 64 columns p), else B = S's columns [64 c, 64 c + 64) (K = rows p).
template <int KS>
__device__ __forceinline__ void wgmma_hilo(float (&d)[32], const uint32_t (&a)[KS][4],
                                           uint32_t s_hi, uint32_t s_lo, int steps,
                                           bool kmajor, int c) {
#pragma unroll
  for (int j = 0; j < 32; ++j) d[j] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk < steps) {
      if (kmajor) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_m64n64_rs_kmajor(d, a[kk], sw128_desc(s_hi + off, 16, 1024));
        wgmma_m64n64_rs_kmajor(d, a[kk], sw128_desc(s_lo + off, 16, 1024));
      } else {
        const uint32_t off = c * kBox + kk * 16 * 128;
        wgmma_m64n64_rs(d, a[kk], sw128_desc(s_hi + off, kBox, 1024));
        wgmma_m64n64_rs(d, a[kk], sw128_desc(s_lo + off, kBox, 1024));
      }
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// Orders this thread's shared-memory accesses through the generic proxy
// before later ones through the async proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The raw f32 state S (P x N, contiguous) into the start of the state boxes
// (4·P·N bytes fit in them: N <= 64·NB) by one bulk copy, issued by the
// calling thread; it completes on bar.
__device__ __forceinline__ void fetch_state(uint8_t* s, const float* __restrict__ src, int P,
                                            int N, uint64_t* bar) {
  const uint32_t bytes = (uint32_t)P * N * 4;
  fence_proxy_async();                 // after the block's reads of the boxes (barrier before)
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(s)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The raw state fetch_state left in the boxes (landed: the caller waited on
// its barrier), converted in place to the
// swizzled bf16 hi + lo boxes (rows p >= P and columns n >= N keep stale
// bytes: they reach only products' columns that are never read). Every
// thread reads its kLoads float4 first, then, after a barrier, writes; the
// caller's barrier publishes the result. With other: adds ⟨other, S⟩ to
// *dot, other the kLoads float4 of another P x N array at this thread's
// indices (threadIdx.x + u · kThreads).
__device__ __forceinline__ void convert_state(uint8_t* s_hi, uint8_t* s_lo, int P, int N,
                                              const float4* other, float* dot) {
  const int total = P * N / 4;         // <= kLoads · kThreads
  float4 v[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    v[u] = i < total ? reinterpret_cast<const float4*>(s_hi)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (other != nullptr) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      *dot += other[u].x * v[u].x + other[u].y * v[u].y + other[u].z * v[u].z +
              other[u].w * v[u].w;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < total) {
      const int p = i / (N / 4), n = (i - p * (N / 4)) * 4;
      uint2 hi, lo;
      split_bf16(v[u].x, v[u].y, hi.x, lo.x);
      split_bf16(v[u].z, v[u].w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(s_hi + sw128_at(p, n)) = hi;
      *reinterpret_cast<uint2*>(s_lo + sw128_at(p, n)) = lo;
    }
  }
  fence_proxy_async();                 // the boxes are wgmma operands next
}

// The index of block (rows jb, columns ib ≥ jb) among the causal blocks
__device__ __forceinline__ int tri_block(int jb, int ib, int nrb) {
  return jb * nrb - jb * (jb - 1) / 2 + (ib - jb);
}

// One 8x8 bf16 matrix of a warp's fragment, transposed
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The end of a head's chunk, by the block's first Q threads, one step each:
// d cum (with d seg = Σ V_j + exp(seg)·⟨dS, S_in⟩ at the last step; the
// intra terms' Σ_j T_ij from the row blocks' partials, in order), its
// reverse cumsum d(dt·A) in f64 (within warps, then over the warps' totals),
// ddt for the valid steps, and this chunk's dA = Σ dt·d(dt·A) and dD
// partials. Sums run in a fixed order; red2 holds 3 · kThreads / 32 f64.
__device__ __forceinline__ void tile_tail(const BwdRows& r, const double* part_row, int Q,
                                          int nval, float A, double eseg_dot, double dD_sum,
                                          float* ddt, size_t ddt_row0, int H, double* dA_part,
                                          double* dD_part, size_t part, double* red2) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = Q / 32;
  double d = 0.0, vs = 0.0;
  if (t < Q) {
    double trow = 0.0;
    for (int jb = 0; jb <= t / 16; ++jb) trow += part_row[(size_t)jb * Q + t];
    vs = r.vs[t];
    d = trow - r.tcol[t] + r.us[t] - vs;
  }
  double suf = d, vw = vs;             // suffix sums over lanes >= this one; Σ V_j
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double x = __shfl_down_sync(0xffffffffu, suf, o);
    if (lane + o < 32) suf += x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vw += __shfl_xor_sync(0xffffffffu, vw, o);
  if (lane == 0 && w < nw) {
    red2[w] = suf;                     // the warp's total
    red2[kThreads / 32 + w] = vw;
  }
  __syncthreads();
  double da = 0.0;
  if (t < Q) {
    double later = 0.0, vsum = 0.0;
    for (int k = 0; k < nw; ++k) {
      vsum += red2[kThreads / 32 + k];
      if (k > w) later += red2[k];
    }
    const double dla = suf + later + vsum + eseg_dot;   // d seg is in every suffix
    da = (double)r.dts[t] * dla;
    if (t < nval) ddt[ddt_row0 + (size_t)t * H] = (float)((double)r.ddt_dir[t] + (double)A * dla);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0 && w < nw) red2[2 * (kThreads / 32) + w] = da;
  __syncthreads();
  if (t == 0) {
    double sum = 0.0;
    for (int k = 0; k < nw; ++k) sum += red2[2 * (kThreads / 32) + k];
    dA_part[part] = sum;
    dD_part[part] = dD_sum;
  }
}

// The bf16 chunk kernel, one block per (chunk, b, group x tile of HT heads).
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_tile_mma(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dp, const bf16* __restrict__ dy,
    const float* __restrict__ s_in, const float* __restrict__ ds_out,
    bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
    float* __restrict__ dC_part, double* __restrict__ dA_part, double* __restrict__ dD_part,
    int S, int H, int G, int P, int N, int Q, int HT) {
  extern __shared__ uint8_t smem_tile[];
  // the swizzled state boxes need a 1024-byte aligned base
  uint8_t* base = smem_tile + ((1024 - (smem_u32(smem_tile) & 1023)) & 1023);
  const TileSmem L(P, N, Q);
  const int ldp = P + kPad, ldn = N + kPad, QR = Q > 64 ? Q : 64;
  uint8_t* s_hi = base + L.s_hi;
  uint8_t* s_lo = base + L.s_lo;
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);
  bf16* dys = reinterpret_cast<bf16*>(base + L.dys);
  bf16* bs = reinterpret_cast<bf16*>(base + L.bs);
  bf16* cs = reinterpret_cast<bf16*>(base + L.cs);
  float* cb = reinterpret_cast<float*>(base + L.cb);
  float* msum = reinterpret_cast<float*>(base + L.msum);
  float* cumx = reinterpret_cast<float*>(base + L.cumx);
  BwdRows R = bwd_rows(base + L.rows, Q);
  double* part_row = reinterpret_cast<double*>(base + L.part_row);
  double* red2 = reinterpret_cast<double*>(base + L.red2);
  float* red = reinterpret_cast<float*>(base + L.red);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int heads = H / G, tiles = (heads + HT - 1) / HT;
  const int g = blockIdx.z / tiles, tile = blockIdx.z - g * tiles;
  const int h0 = g * heads + tile * HT, nh = min(HT, heads - tile * HT);
  const int s0 = c * Q, nval = min(Q, S - s0), nrb = Q / 16, NB = (N + 63) / 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  // warp w owns row block w (rows 16w .. 16w + 15): as rows j of dx and dB, as
  // rows i of dC. A warpgroup runs wgmma over its 64 rows while it has a row
  // block; its warps past nrb (Q = 32) multiply the zero rows.
  const bool wg_on = 64 * (warp >> 2) < Q, own = warp < nrb;
  const int r0 = 16 * warp, ra = r0 + g4, rb = ra + 8;
  const uint32_t shi = smem_u32(s_hi), slo = smem_u32(s_lo);

  // x, dy and the raw dS of head hh (its loads stay in flight until needed);
  // the states' barrier completes once a copy, phase `phase` next
  int phase = 0;
  auto fetch_head = [&](int hh) {
    const int h = h0 + hh;
    const size_t xo = (((size_t)b * S + s0) * H + h) * P;
    copy_rows(xs, ldp, x + xo, (size_t)H * P, QR, nval, P);
    copy_rows(dys, ldp, dy + xo, (size_t)H * P, QR, nval, P);
    cp_async_commit();
    if (tid == 0) fetch_state(s_hi, ds_out + (((size_t)b * nc + c) * H + h) * P * N, P, N, bar);
  };
  auto wait_state = [&]() {
    mbar_wait(bar, phase);
    phase ^= 1;
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t bo = (((size_t)b * S + s0) * G + g) * N;
  copy_rows(bs, ldn, Bm + bo, (size_t)G * N, QR, nval, N);
  copy_rows(cs, ldn, Cm + bo, (size_t)G * N, QR, nval, N);
  cp_async_commit();
  fetch_head(0);
  cp_async_wait<1>();                  // B and C
  __syncthreads();
  // B_j·C_i for the causal blocks, once for the tile's heads (round robin
  // over the warps); Σ Mᵀ starts at 0
  for (int jb = 0, k = 0; jb < nrb; ++jb)
    for (int ib = jb; ib < nrb; ++ib, ++k) {
      if (k % (kThreads / 32) != warp) continue;
      float acc[2][4];
      mma_abt(acc, bs, ldn, 16 * jb, cs, ldn, 16 * ib, N, lane);
      float4* dst = reinterpret_cast<float4*>(cb + k * 256) + lane * 2;
      dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
      float4* ms = reinterpret_cast<float4*>(msum + k * 256) + lane * 2;
      ms[0] = ms[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // dB (rows j) of the warp's row block, summed over the tile's heads in
  // registers; dC (rows i) in its partial in device memory, which only this
  // thread reads and writes (rows ra and rb, its columns)
  float acc_b[kMaxN / 8][4];
  zero_acc(acc_b);
  const size_t parts = (size_t)gridDim.z;   // G x tiles partials a row
  const size_t po = (((size_t)b * S + s0) * parts + blockIdx.z) * N;
  float* dc_a = dC_part + po + (size_t)ra * parts * N;   // row ra (rb: + 8 rows)
  float* dc_b = dc_a + 8 * parts * N;

  // one warp: dt of head hh and cum, its prefix sums of dt·A in f64, kept as
  // an f32 hi + lo pair, into cum buffer hh % 2
  auto scan_head = [&](int hh) {
    float* cx = cumx + (hh & 1) * 3 * Q;
    for (int i = lane; i < Q; i += 32)
      cx[2 * Q + i] = i < nval ? dt[((size_t)b * S + s0 + i) * H + h0 + hh] : 0.f;
    __syncwarp();
    double cv[kMaxQ / 32];
    const int per = Q / 32;
    warp_cum(cx + 2 * Q, -expf(A_log[h0 + hh]), per, lane, cv);
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e) {
      if (e < per) {
        const float hi = (float)cv[e];
        cx[lane * per + e] = hi;
        cx[Q + lane * per + e] = (float)(cv[e] - (double)hi);
      }
    }
  };
  if (warp == 0) scan_head(0);

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const size_t xo = (((size_t)b * S + s0) * H + h) * P;
    const size_t so = (((size_t)b * nc + c) * H + h) * P * N;
    const float A = -expf(A_log[h]);
    const float* cum_hi = cumx + (hh & 1) * 3 * Q;
    const float* cum_lo = cum_hi + Q;
    R.dts = cumx + (hh & 1) * 3 * Q + 2 * Q;
    cp_async_wait<0>();                // x, dy and the raw dS of head hh
    wait_state();
    __syncthreads();
    convert_state(s_hi, s_lo, P, N, nullptr, nullptr);   // dS as bf16 hi + lo
    __syncthreads();
    const int rra = own ? ra : 0, rrb = own ? rb : 0;
    const float seg_hi = cum_hi[Q - 1], seg_lo = cum_lo[Q - 1];
    const float hia = cum_hi[rra], loa = cum_lo[rra], hib = cum_hi[rrb], lob = cum_lo[rrb];
    const float dta = R.dts[rra], dtb = R.dts[rrb];
    const float era = ex2(kLog2e * ((seg_hi - hia) + (seg_lo - loa)));   // exp(seg − cum_j)
    const float erb = ex2(kLog2e * ((seg_hi - hib) + (seg_lo - lob)));
    const float wa = era * dta, wb = erb * dtb;                          // w_j

    // ---- rows j, the products with dS: dB's carry w_j·x_jᵀ·dS (columns n),
    // and dx's carry w_j·B_j·dSᵀ (columns p) with its dot with x_j ----
    float acc_p[kMaxP / 8][4];         // dx: P columns (the wgmma's d[4 nb + e])
    if (wg_on) {
      {
        uint32_t a[kMaxP / 16][4];
        load_a_frags(a, xs, ldp, r0, P / 16, lane);
#pragma unroll
        for (int cn = 0; cn < kMaxN / 64; ++cn) {
          if (cn < NB) {
            float d[32];
            wgmma_hilo(d, a, shi, slo, P / 16, false, cn);
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              if (own && 64 * cn + 8 * nb < N) {
                acc_b[8 * cn + nb][0] += wa * d[4 * nb];
                acc_b[8 * cn + nb][1] += wa * d[4 * nb + 1];
                acc_b[8 * cn + nb][2] += wb * d[4 * nb + 2];
                acc_b[8 * cn + nb][3] += wb * d[4 * nb + 3];
              }
            }
          }
        }
      }
      uint32_t a[kMaxN / 16][4];       // K = the N states
      load_a_frags(a, bs, ldn, r0, N / 16, lane);
      wgmma_hilo(reinterpret_cast<float(&)[32]>(acc_p), a, shi, slo, N / 16, true, 0);
    }
    __syncthreads();                   // every warp is done with dS
    if (tid == 0) fetch_state(s_hi, s_in + so, P, N, bar);   // arrives during the intra work

    // ---- rows j: the intra terms into dx, the direct ddt, d cum at j, Σ Mᵀ ----
    if (own) {
      float xa, xb;
      frag_row_dots(acc_p, xs + ra * ldp, xs + rb * ldp, P, t4, xa, xb);
      scale_rows(acc_p, wa, wb);
      // column blocks i ≥ j: T_ij = (C_i·B_j)·e_ij·(dy_i·x_j)·dt_j
      float ta = 0.f, tb = 0.f;        // Σ_i T_ij / dt_j (the direct ddt)
      double Ta = 0.0, Tb = 0.0;       // Σ_i T_ij
      for (int ib = warp; ib < nrb; ++ib) {
        const int blk = tri_block(warp, ib, nrb);
        const float4* cp = reinterpret_cast<const float4*>(cb + blk * 256) + lane * 2;
        const float4 c0 = cp[0], c1 = cp[1];
        const float cbt[2][4] = {{c0.x, c0.y, c0.z, c0.w}, {c1.x, c1.y, c1.z, c1.w}};
        float dyx[2][4];
        mma_abt(dyx, xs, ldp, r0, dys, ldp, 16 * ib, P, lane);   // x_j·dy_i
        float gv[8], mv[8];
        double col[2][2];              // Σ over this thread's rows of T at columns i, i + 1
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 16 * ib + 8 * u + 2 * t4;
          const float2 hi = *reinterpret_cast<const float2*>(cum_hi + i);
          const float2 lo = *reinterpret_cast<const float2*>(cum_lo + i);
          const float e[4] = {masked_decay(i, ra, hi.x, lo.x, hia, loa),
                              masked_decay(i + 1, ra, hi.y, lo.y, hia, loa),
                              masked_decay(i, rb, hi.x, lo.x, hib, lob),
                              masked_decay(i + 1, rb, hi.y, lo.y, hib, lob)};
          col[u][0] = col[u][1] = 0.0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float dtj = q < 2 ? dta : dtb;
            const float ce = cbt[u][q] * e[q], t = ce * dyx[u][q];
            const double td = (double)(t * dtj);
            gv[4 * u + q] = ce * dtj;
            mv[4 * u + q] = e[q] * dtj * dyx[u][q];
            col[u][q & 1] += td;
            if (q < 2) {
              ta += t;
              Ta += td;
            } else {
              tb += t;
              Tb += td;
            }
          }
        }
        float4* mp = reinterpret_cast<float4*>(msum + blk * 256) + lane * 2;
        float4 m0 = mp[0], m1 = mp[1];
        m0.x += mv[0];
        m0.y += mv[1];
        m0.z += mv[2];
        m0.w += mv[3];
        m1.x += mv[4];
        m1.y += mv[5];
        m1.z += mv[6];
        m1.w += mv[7];
        mp[0] = m0;
        mp[1] = m1;
        // T summed over the block's 16 rows j (the 8 lanes of a column,
        // lane bits 2-4), for the 16 columns i: d cum at i. A reduce-scatter:
        // bit 4 keeps half u, bit 3 parity q, then bit 2 adds the last pair.
        {
          const bool b4 = lane & 16, b3 = lane & 8;
          double h0 = b4 ? col[1][0] : col[0][0], h1 = b4 ? col[1][1] : col[0][1];
          h0 += __shfl_xor_sync(0xffffffffu, b4 ? col[0][0] : col[1][0], 16);
          h1 += __shfl_xor_sync(0xffffffffu, b4 ? col[0][1] : col[1][1], 16);
          double v = b3 ? h1 : h0;
          v += __shfl_xor_sync(0xffffffffu, b3 ? h0 : h1, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          if ((lane & 4) == 0)
            part_row[(size_t)warp * Q + 16 * ib + 8 * b4 + 2 * t4 + b3] = v;
        }
        uint32_t gh[4], gl[4];
        frag_hi_lo(gv, gh, gl);
        mma_frag_rows(acc_p, gh, gl, dys, ldp, 16 * ib, P, lane);   // dx += Gᵀ·dy_i
      }
      ta += __shfl_xor_sync(0xffffffffu, ta, 1);
      ta += __shfl_xor_sync(0xffffffffu, ta, 2);
      tb += __shfl_xor_sync(0xffffffffu, tb, 1);
      tb += __shfl_xor_sync(0xffffffffu, tb, 2);
      Ta += __shfl_xor_sync(0xffffffffu, Ta, 1);
      Ta += __shfl_xor_sync(0xffffffffu, Ta, 2);
      Tb += __shfl_xor_sync(0xffffffffu, Tb, 1);
      Tb += __shfl_xor_sync(0xffffffffu, Tb, 2);
      if (t4 == 0) {
        R.ddt_dir[ra] = ta + era * xa;
        R.ddt_dir[rb] = tb + erb * xb;
        R.tcol[ra] = Ta;
        R.tcol[rb] = Tb;
        R.vs[ra] = wa * xa;
        R.vs[rb] = wb * xb;
      }
      const float Dh = Dp[h];
#pragma unroll
      for (int nt = 0; nt < kMaxP / 8; ++nt) {
        if (8 * nt < P) {
          const int p = 8 * nt + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = ra + 8 * half;
            if (j < nval) {
              const float2 d = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(dys + j * ldp + p));
              *reinterpret_cast<uint32_t*>(dx + xo + (size_t)j * H * P + p) =
                  pack_bf16(acc_p[nt][2 * half] + Dh * d.x, acc_p[nt][2 * half + 1] + Dh * d.y);
            }
          }
        }
      }
    }
    // the last warp has the least intra work: it scans the next head meanwhile
    if (warp == kThreads / 32 - 1 && hh + 1 < nh) scan_head(hh + 1);
    float dd = 0.f;                    // dD: Σ dy·x over the chunk
    for (int i = tid; i < nval * P / 2; i += kThreads) {
      const int j = i / (P / 2), p = (i - j * (P / 2)) * 2;
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + j * ldp + p));
      const float2 d =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dys + j * ldp + p));
      dd += a.x * d.x + a.y * d.y;
    }
    float4 ds[kLoads];                 // dS again from device memory, for ⟨dS, S_in⟩
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      ds[u] = i < P * N / 4 ? *reinterpret_cast<const float4*>(ds_out + so + 4 * (size_t)i)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    wait_state();                      // S_in
    __syncthreads();
    float dot = 0.f;
    convert_state(s_hi, s_lo, P, N, ds, &dot);   // S_in as bf16 hi + lo
    float dot_all, dD_all;             // (the barriers also publish S_in)
    block_sum2_f32(dot, dd, red, dot_all, dD_all);

    // ---- rows i: inter exp(cum_i)·dy_iᵀ·S_in into dC, and its dot with C_i ----
    if (wg_on) {
      const float eca = ex2(kLog2e * (hia + loa)), ecb = ex2(kLog2e * (hib + lob));
      float ua = 0.f, ub = 0.f;
      uint32_t a[kMaxP / 16][4];
      load_a_frags(a, dys, ldp, r0, P / 16, lane);
#pragma unroll
      for (int cn = 0; cn < kMaxN / 64; ++cn) {
        if (cn < NB) {
          // this chunk's partial so far, read before the product so that the
          // reads overlap it
          float2 oa[8], ob[8];
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int n = 64 * cn + 8 * nb + 2 * t4;
            const bool col = own && hh > 0 && 64 * cn + 8 * nb < N;
            oa[nb] = col && ra < nval ? *reinterpret_cast<const float2*>(dc_a + n)
                                      : make_float2(0.f, 0.f);
            ob[nb] = col && rb < nval ? *reinterpret_cast<const float2*>(dc_b + n)
                                      : make_float2(0.f, 0.f);
          }
          float d[32];
          wgmma_hilo(d, a, shi, slo, P / 16, false, cn);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int n = 64 * cn + 8 * nb + 2 * t4;
            if (own && 64 * cn + 8 * nb < N) {
              const float2 ca = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(cs + ra * ldn + n));
              const float2 cbv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(cs + rb * ldn + n));
              const float v0 = eca * d[4 * nb], v1 = eca * d[4 * nb + 1];
              const float v2 = ecb * d[4 * nb + 2], v3 = ecb * d[4 * nb + 3];
              ua += v0 * ca.x + v1 * ca.y;
              ub += v2 * cbv.x + v3 * cbv.y;
              if (ra < nval)
                *reinterpret_cast<float2*>(dc_a + n) = make_float2(oa[nb].x + v0, oa[nb].y + v1);
              if (rb < nval)
                *reinterpret_cast<float2*>(dc_b + n) = make_float2(ob[nb].x + v2, ob[nb].y + v3);
            }
          }
        }
      }
      ua += __shfl_xor_sync(0xffffffffu, ua, 1);
      ua += __shfl_xor_sync(0xffffffffu, ua, 2);
      ub += __shfl_xor_sync(0xffffffffu, ub, 1);
      ub += __shfl_xor_sync(0xffffffffu, ub, 2);
      if (own && t4 == 0) {
        R.us[ra] = ua;
        R.us[rb] = ub;
      }
    }
    __syncthreads();                   // x, dy and the state boxes are free
    if (hh + 1 < nh) fetch_head(hh + 1);   // in flight during this head's tail
    tile_tail(R, part_row, Q, nval, A, exp((double)seg_hi + (double)seg_lo) * dot_all, dD_all,
              ddt, ((size_t)b * S + s0) * H + h, H, dA_part, dD_part,
              ((size_t)b * nc + c) * H + h, red2);
  }
  __syncthreads();                     // Σ Mᵀ is complete

  if (own) {
    // dB_j += Σ_{i ≥ j} (Σ_h M_ij)·C_i, with Σ_h Mᵀ as the A fragments (hi + lo)
    for (int ib = warp; ib < nrb; ++ib) {
      const float4* mp = reinterpret_cast<const float4*>(msum + tri_block(warp, ib, nrb) * 256) +
                         lane * 2;
      const float4 m0 = mp[0], m1 = mp[1];
      const float v[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      uint32_t mh[4], ml[4];
      frag_hi_lo(v, mh, ml);
      mma_frag_rows(acc_b, mh, ml, cs, ldn, 16 * ib, N, lane);
    }
    // dC_i += Σ_{j ≤ i} (Σ_h M_ij)·B_j: block (rows j, columns i) transposed in
    // registers, its 8x8 quarters moved (movmatrix) and swapped off the diagonal
    float acc_c[kMaxN / 8][4];
    zero_acc(acc_c);
    for (int jb = 0; jb <= warp; ++jb) {
      const float4* mp = reinterpret_cast<const float4*>(msum + tri_block(jb, warp, nrb) * 256) +
                         lane * 2;
      const float4 m0 = mp[0], m1 = mp[1];
      const float v[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      uint32_t mh[4], ml[4];
      frag_hi_lo(v, mh, ml);
      const uint32_t th[4] = {movmatrix_t(mh[0]), movmatrix_t(mh[2]), movmatrix_t(mh[1]),
                              movmatrix_t(mh[3])};
      const uint32_t tl[4] = {movmatrix_t(ml[0]), movmatrix_t(ml[2]), movmatrix_t(ml[1]),
                              movmatrix_t(ml[3])};
      mma_frag_rows(acc_c, th, tl, bs, ldn, 16 * jb, N, lane);
    }
    store_rows_f32(acc_b, dB_part + po, parts * N, ra, nval, N, t4);
    float2 oa[kMaxN / 8], ob[kMaxN / 8];   // the inter terms are in the partial
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t4;
      oa[nt] = 8 * nt < N && ra < nval ? *reinterpret_cast<const float2*>(dc_a + n)
                                       : make_float2(0.f, 0.f);
      ob[nt] = 8 * nt < N && rb < nval ? *reinterpret_cast<const float2*>(dc_b + n)
                                       : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      if (8 * nt < N) {
        const int n = 8 * nt + 2 * t4;
        if (ra < nval)
          *reinterpret_cast<float2*>(dc_a + n) =
              make_float2(oa[nt].x + acc_c[nt][0], oa[nt].y + acc_c[nt][1]);
        if (rb < nval)
          *reinterpret_cast<float2*>(dc_b + n) =
              make_float2(ob[nt].x + acc_c[nt][2], ob[nt].y + acc_c[nt][3]);
      }
    }
  }
}

// ---- the f32 instance, on the CUDA cores ----
// At mamba2's decays ddt_j is the sum of parts ~1e3 times larger than it
// (the direct term, x_j·dS·B_j, and A·d(dt·A) with A up to 64), which take
// the rounding of every f32 intermediate (the chunk states, dS, C·B, dy·x,
// the decays) to ~1e-3 absolute: two f32 evaluations in another order do
// not agree to 1e-4 there. So the f32 instance computes in f64 from its f32
// inputs, chunk states and dS included, and rounds each gradient once.

// Chunk states in f64, one block per (chunk, b, head): s_c = (w⊙x)ᵀ·B and
// decays exp(cum_Q); kBwd: Σ_i exp(cum_i)·dy_i ⊗ C_i (no decays).
template <bool kBwd>
__global__ void __launch_bounds__(kThreads) ssd_states_f64(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const float* __restrict__ Bm,
    double* __restrict__ states, double* __restrict__ decay, int S, int H, int G, int P,
    int N, int Q) {
  extern __shared__ float4 smem_sf[];
  double* ws = reinterpret_cast<double*>(smem_sf);  // [Q]: w
  float* xf = reinterpret_cast<float*>(ws + Q);     // [Q][P]
  float* bf = xf + Q * P;                           // [Q][N]
  float* dts = bf + Q * N;                          // [Q]
  const int c = blockIdx.x, b = blockIdx.y, h = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G), s0 = c * Q, nval = min(Q, S - s0);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < Q * P; i += kThreads) {
    const int j = i / P, p = i - j * P;
    xf[i] = j < nval ? x[(((size_t)b * S + s0 + j) * H + h) * P + p] : 0.f;
  }
  for (int i = tid; i < Q * N; i += kThreads) {
    const int j = i / N, n = i - j * N;
    bf[i] = j < nval ? Bm[(((size_t)b * S + s0 + j) * G + g) * N + n] : 0.f;
  }
  for (int i = tid; i < Q; i += kThreads)
    dts[i] = i < nval ? dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
  __syncthreads();
  if (tid < 32) {
    const int per = Q / 32;
    double cum[kMaxQ / 32];
    const double total = warp_cum(dts, -expf(A_log[h]), per, lane, cum);
    for (int e = 0; e < per; ++e) {
      const int t = lane * per + e;
      ws[t] = kBwd ? (t < nval ? exp(cum[e]) : 0.0) : exp(total - cum[e]) * (double)dts[t];
    }
    if (!kBwd && lane == 0) decay[((size_t)b * nc + c) * H + h] = exp(total);
  }
  __syncthreads();
  double* dst = states + (((size_t)b * nc + c) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    double s = 0.0;
    for (int j = 0; j < Q; ++j) s += ws[j] * (double)xf[j * P + p] * (double)bf[j * N + n];
    dst[i] = s;
  }
}

// The walk over chunks in f64, per (b, state element). Forward: slot c
// becomes S_in[c] (from init, or 0); reverse: slot c becomes dS[c] (from
// dfinal, or 0) and ``out`` (unless NULL) gets d init.
template <bool kReverse>
__global__ void __launch_bounds__(kThreads) ssd_walk_f64(
    double* __restrict__ st, const double* __restrict__ decay, const float* __restrict__ in,
    float* __restrict__ out, int nc, int H, int PN) {
  const int b = blockIdx.y;
  const size_t per_b = (size_t)H * PN;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_b) return;
  const int h = (int)(i / PN);
  double v = in ? (double)in[b * per_b + i] : 0.0;
  double* p = st + (size_t)b * nc * per_b + i;
  const double* dc = decay + (size_t)b * nc * H + h;
  for (int k = 0; k < nc; ++k) {
    const int c = kReverse ? nc - 1 - k : k;
    const double s_c = p[(size_t)c * per_b];
    p[(size_t)c * per_b] = v;
    v = dc[(size_t)c * H] * v + s_c;
  }
  if (kReverse && out) out[b * per_b + i] = (float)v;
}

// The f32 chunk kernel, one block per (chunk, b, head), in f64: C_i·B_j and
// dy_i·x_j for i ≥ j in shared memory (packed lower triangles), then each
// output as a plain loop; x, dy, B, C, S_in and dS read through the cache.
__global__ void __launch_bounds__(kThreads) ssd_bwd_cuda_cores(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dp, const float* __restrict__ dy,
    const double* __restrict__ s_in, const double* __restrict__ ds_out,
    float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
    float* __restrict__ dC_part, double* __restrict__ dA_part, double* __restrict__ dD_part,
    int S, int H, int G, int P, int N, int Q) {
  extern __shared__ float4 smem_bf32[];
  double* cum = reinterpret_cast<double*>(smem_bf32);   // [Q]
  const BwdRows R = bwd_rows(cum + Q, Q);
  double* cb = cum + Q + bwd_rows_bytes(Q) / 8;          // packed [i(i+1)/2 + j]: C_i·B_j
  double* dyx = cb + Q * (Q + 1) / 2;                    //                        dy_i·x_j
  double* red = dyx + Q * (Q + 1) / 2;                   // [kThreads / 32]

  const int c = blockIdx.x, b = blockIdx.y, h = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G), s0 = c * Q, nval = min(Q, S - s0);
  const int tid = threadIdx.x, lane = tid & 31;
  const float A = -expf(A_log[h]);
  const double Dh = Dp[h];
  const size_t xo = (((size_t)b * S + s0) * H + h) * P, xl = (size_t)H * P;
  const size_t bo = (((size_t)b * S + s0) * G + g) * N, bl = (size_t)G * N;
  const size_t so = (((size_t)b * nc + c) * H + h) * P * N;
  const float* X = x + xo;
  const float* DY = dy + xo;
  const float* BB = Bm + bo;
  const float* CC = Cm + bo;
  const double* SI = s_in + so;
  const double* DS = ds_out + so;
  auto tri = [](int i, int j) { return i * (i + 1) / 2 + j; };

  for (int i = tid; i < Q; i += kThreads)
    R.dts[i] = i < nval ? dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
  __syncthreads();
  if (tid < 32) {
    double cv[kMaxQ / 32];
    const int per = Q / 32;
    warp_cum(R.dts, A, per, lane, cv);
    for (int e = 0; e < per; ++e) cum[lane * per + e] = cv[e];
  }
  for (int idx = tid; idx < Q * (Q + 1) / 2; idx += kThreads) {
    int i = (int)((sqrt(8.0 * idx + 1.0) - 1.0) / 2.0);
    while (tri(i + 1, 0) <= idx) ++i;
    while (tri(i, 0) > idx) --i;
    const int j = idx - tri(i, 0);
    double s1 = 0.0, s2 = 0.0;
    if (i < nval) {
      for (int n = 0; n < N; ++n) s1 += (double)CC[i * bl + n] * (double)BB[j * bl + n];
      for (int p = 0; p < P; ++p) s2 += (double)DY[i * xl + p] * (double)X[j * xl + p];
    }
    cb[idx] = s1;
    dyx[idx] = s2;
  }
  __syncthreads();
  const double seg = cum[Q - 1];
  // T_ij = (C_i·B_j)·e_ij·(dy_i·x_j)·dt_j
  if (tid < Q) {                       // columns j: direct ddt, Σ_i T_ij
    const int j = tid;
    double t = 0.0;
    for (int i = j; i < Q; ++i) t += cb[tri(i, j)] * exp(cum[i] - cum[j]) * dyx[tri(i, j)];
    R.ddt_dir[j] = t;
    R.tcol[j] = t * R.dts[j];
  } else if (tid < 2 * Q) {            // rows i: Σ_j T_ij
    const int i = tid - Q;
    double t = 0.0;
    for (int j = 0; j <= i; ++j)
      t += cb[tri(i, j)] * exp(cum[i] - cum[j]) * dyx[tri(i, j)] * R.dts[j];
    R.trow[i] = t;
  }
  __syncthreads();
  if (tid < Q) {                       // carry at j: x_jᵀ·dS·B_j; inter at i: dy_iᵀ·S_in·C_i
    const int j = tid;
    double xr = 0.0, ur = 0.0;
    if (j < nval) {
      for (int p = 0; p < P; ++p) {
        double sb = 0.0, sc = 0.0;
        for (int n = 0; n < N; ++n) {
          sb += DS[p * N + n] * BB[j * bl + n];
          sc += SI[p * N + n] * CC[j * bl + n];
        }
        xr += X[j * xl + p] * sb;
        ur += DY[j * xl + p] * sc;
      }
    }
    const double er = exp(seg - cum[j]);
    R.ddt_dir[j] += er * xr;
    R.vs[j] = er * R.dts[j] * xr;
    R.us[j] = exp(cum[j]) * ur;
  }
  for (int idx = tid; idx < nval * P; idx += kThreads) {   // dx
    const int j = idx / P, p = idx - j * P;
    double s = 0.0, r6 = 0.0;
    for (int i = j; i < nval; ++i)
      s += cb[tri(i, j)] * exp(cum[i] - cum[j]) * (double)DY[i * xl + p];
    for (int n = 0; n < N; ++n) r6 += BB[j * bl + n] * DS[p * N + n];
    const double w = exp(seg - cum[j]) * R.dts[j];
    dx[xo + j * xl + p] = (float)(s * R.dts[j] + w * r6 + Dh * DY[j * xl + p]);
  }
  for (int idx = tid; idx < nval * N; idx += kThreads) {   // dB, dC of this head
    const int j = idx / N, n = idx - j * N;
    double sb = 0.0, sc = 0.0, r7 = 0.0, r8 = 0.0;
    for (int i = j; i < nval; ++i)
      sb += exp(cum[i] - cum[j]) * dyx[tri(i, j)] * (double)CC[i * bl + n];
    for (int k = 0; k <= j; ++k)
      sc += exp(cum[j] - cum[k]) * R.dts[k] * dyx[tri(j, k)] * (double)BB[k * bl + n];
    for (int p = 0; p < P; ++p) {
      r7 += X[j * xl + p] * DS[p * N + n];
      r8 += DY[j * xl + p] * SI[p * N + n];
    }
    const size_t o = (((size_t)b * S + s0 + j) * H + h) * N + n;
    dB_part[o] = (float)(sb * R.dts[j] + exp(seg - cum[j]) * R.dts[j] * r7);
    dC_part[o] = (float)(sc + exp(cum[j]) * r8);
  }
  double dot = 0.0, dd = 0.0;
  for (int i = tid; i < P * N; i += kThreads) dot += DS[i] * SI[i];
  for (int i = tid; i < nval * P; i += kThreads) {
    const int j = i / P, p = i - j * P;
    dd += (double)DY[j * xl + p] * (double)X[j * xl + p];
  }
  const double dot_all = block_sum_f64(dot, red);
  const double dD_all = block_sum_f64(dd, red);
  __syncthreads();
  bwd_chunk_tail(R, Q, nval, A, exp(seg) * dot_all, dD_all, ddt, ((size_t)b * S + s0) * H + h,
                 H, dA_part, dD_part, ((size_t)b * nc + c) * H + h);
}

// dB, dC: the (B, S, G x per_group, N) partials (per head, or per tile of
// heads) summed over the per_group partials of each group, in order, in the
// inputs' dtype; dA_log = A·Σ dA and dD = Σ dD over the (b, chunk)
// partials, in order, by block 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part,
    const double* __restrict__ dA_part, const double* __restrict__ dD_part,
    const float* __restrict__ A_log, T* __restrict__ dB, T* __restrict__ dC,
    float* __restrict__ dA_log, float* __restrict__ dD, int BS, int H, int G, int N,
    int parts, int per_group) {
  const size_t total = (size_t)BS * G * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(idx % N);
    const size_t rest = idx / N;
    const int g = (int)(rest % G);
    const size_t bs = rest / G;
    const size_t o = ((bs * G + g) * per_group) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < per_group; ++r) {
      sb += dB_part[o + (size_t)r * N];
      sc += dC_part[o + (size_t)r * N];
    }
    store(dB + idx, sb);
    store(dC + idx, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      double a = 0.0, d = 0.0;
      for (int k = 0; k < parts; ++k) {
        a += dA_part[(size_t)k * H + h];
        d += dD_part[(size_t)k * H + h];
      }
      dA_log[h] = (float)(-(double)expf(A_log[h]) * a);
      dD[h] = (float)d;
    }
  }
}

size_t bwd_f32_smem(int Q) {
  return (size_t)Q * 8 + bwd_rows_bytes(Q) + (size_t)Q * (Q + 1) * 8 + kThreads / 32 * 8;
}

size_t states_f64_smem(int P, int N, int Q) {
  return (size_t)Q * 8 + ((size_t)Q * P + (size_t)Q * N + Q) * 4;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <bool kBwd>
int launch_states_f64(const void* x, const void* dt, const void* A_log, const void* Bm,
                      void* states, void* decay, int Bb, int S, int H, int G, int P, int N,
                      int Q, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  const size_t smem = states_f64_smem(P, N, Q);
  const int e = set_smem(ssd_states_f64<kBwd>, smem);
  if (e) return e;
  ssd_states_f64<kBwd><<<dim3((S + Q - 1) / Q, Bb, H), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(Bm),
      static_cast<double*>(states), static_cast<double*>(decay), S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const void* dB_part, const void* dC_part, const void* dA_part,
                  const void* dD_part, const void* A_log, void* dB, void* dC, void* dA_log,
                  void* dD, int Bb, int S, int H, int G, int N, int Q, int per_group,
                  void* stream) {
  if (per_group < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)Bb * S * G * N;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 4096
                               ? (total + kThreads - 1) / kThreads : 4096);
  ssd_bwd_finish<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const double*>(dA_part), static_cast<const double*>(dD_part),
      static_cast<const float*>(A_log), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA_log), static_cast<float*>(dD), Bb * S, H, G, N,
      Bb * ((S + Q - 1) / Q), per_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B,S,H,P), B/C (B,S,G,N) f32; dt (B,S,H), A_log/D (H,), init (B,H,P,N)
// f32 (init may be NULL: a zero state) → y (B,S,H,P) f32, final (B,H,P,N)
// f32. P, N, Q are multiples of 32 with P <= 64, N <= 128, Q <= 128.
int ssd_scan_f32(const void* x, const void* dt, const void* A_log, const void* Bm,
                 const void* Cm, const void* Dp, const void* init, void* y,
                 void* final_state, int Bb, int S, int H, int G, int P, int N,
                 int Q, void* stream) {
  return launch<float>(x, dt, A_log, Bm, Cm, Dp, init, y, final_state, Bb, S, H,
                       G, P, N, Q, stream);
}

// The CUDA-core design on bf16 x, B, C and y (the scan itself f32): not on
// any path of the port, timed beside the three bf16 passes below.
int ssd_scan_bf16_cuda_cores(const void* x, const void* dt, const void* A_log,
                             const void* Bm, const void* Cm, const void* Dp,
                             const void* init, void* y, void* final_state, int Bb, int S,
                             int H, int G, int P, int N, int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, Dp, init, y, final_state,
                               Bb, S, H, G, P, N, Q, stream);
}

// The bf16 scan (x, B, C and y bf16, 16-byte aligned) is three launches on
// one stream, in this order; states (B, nc, H, P, N) and decay (B, nc, H)
// f32 are scratch, nc = ceil(S / Q). Same shapes as ssd_scan_f32.
// 1. chunk states and decays
int ssd_bf16_states(const void* x, const void* dt, const void* A_log, const void* Bm,
                    void* states, void* decay, int Bb, int S, int H, int G, int P, int N,
                    int Q, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  const int HT = heads_per_tile(H, G, 4);
  return launch_states<false>(x, dt, A_log, Bm, states, decay, Bb, S, H, G, P, N, Q, stream);
}

// 2. the state pass (init may be NULL: a zero state)
int ssd_bf16_pass(void* states, const void* decay, const void* init, void* final_state,
                  int Bb, int S, int H, int P, int N, int Q, void* stream) {
  const int PN = P * N;
  const dim3 grid(((size_t)H * PN / 4 + kThreads - 1) / kThreads, Bb);
  ssd_state_pass<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(init), static_cast<float*>(final_state), (S + Q - 1) / Q,
      H, PN);
  return (int)cudaGetLastError();
}

// 3. the output y
int ssd_bf16_output(const void* x, const void* dt, const void* A_log, const void* Bm,
                    const void* Cm, const void* Dp, const void* states, void* y, int Bb,
                    int S, int H, int G, int P, int N, int Q, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  const int HT = heads_per_tile(H, G, 8);
  const size_t smem = OutputSmem(P, N, Q, HT).bytes;
  cudaError_t e = cudaFuncSetAttribute(ssd_output_mma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + Q - 1) / Q, Bb, H / HT);
  ssd_output_mma<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(states), static_cast<bf16*>(y), S, H, G, P, N, Q, HT);
  return (int)cudaGetLastError();
}

// The backward, as launches on one stream in this order (bwd_launches in
// ssd_scan.py). bf16: ssd_bf16_states, ssd_bf16_pass (the forward's chunk
// states), ssd_bf16_dstates, ssd_bwd_pass, ssd_bwd_bf16,
// ssd_bwd_finish_bf16. f32: ssd_f32_states, ssd_f64_walk (forward),
// ssd_f32_dstates, ssd_f64_walk (reverse), ssd_bwd_f32, ssd_bwd_finish_f32.
// Scratch: states and dstates (B, nc, H, P, N) and decay (B, nc, H), f32 in
// bf16 and f64 in f32; dA_part, dD_part (B, nc, H) f64; dB_part, dC_part
// (B, S, H, N) f32. Shapes as ssd_scan_f32.
// dstates: Σ_i exp(cum_i)·dy_i ⊗ C_i per chunk (dy, C bf16)
int ssd_bf16_dstates(const void* dy, const void* dt, const void* A_log, const void* Cm,
                     void* dstates, int Bb, int S, int H, int G, int P, int N, int Q,
                     void* stream) {
  return launch_states<true>(dy, dt, A_log, Cm, dstates, nullptr, Bb, S, H, G, P, N, Q,
                             stream);
}

// f32 x, B: chunk states and decays in f64
int ssd_f32_states(const void* x, const void* dt, const void* A_log, const void* Bm,
                   void* states, void* decay, int Bb, int S, int H, int G, int P, int N,
                   int Q, void* stream) {
  return launch_states_f64<false>(x, dt, A_log, Bm, states, decay, Bb, S, H, G, P, N, Q,
                                  stream);
}

// f32 dy, C: dstates in f64
int ssd_f32_dstates(const void* dy, const void* dt, const void* A_log, const void* Cm,
                    void* dstates, int Bb, int S, int H, int G, int P, int N, int Q,
                    void* stream) {
  return launch_states_f64<true>(dy, dt, A_log, Cm, dstates, nullptr, Bb, S, H, G, P, N, Q,
                                 stream);
}

// the reverse pass over chunks (dfinal and dinit may be NULL)
int ssd_bwd_pass(void* dstates, const void* decay, const void* dfinal, void* dinit, int Bb,
                 int S, int H, int P, int N, int Q, void* stream) {
  const int PN = P * N;
  const dim3 grid(((size_t)H * PN / 4 + kThreads - 1) / kThreads, Bb);
  ssd_dstate_pass<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dstates), static_cast<const float*>(decay),
      static_cast<const float*>(dfinal), static_cast<float*>(dinit), (S + Q - 1) / Q, H, PN);
  return (int)cudaGetLastError();
}

// the f32 path's walks over chunks in f64: forward (reverse = 0) makes the
// chunk states S_in[c] from ``in`` = init (may be NULL); reverse makes dS[c]
// from ``in`` = dfinal (may be NULL) and writes d init to ``out`` (may be
// NULL). states (B, nc, H, P, N) and decay (B, nc, H) f64.
int ssd_f64_walk(void* states, const void* decay, const void* in, void* out, int Bb, int S,
                 int H, int P, int N, int Q, int reverse, void* stream) {
  const int PN = P * N;
  const dim3 grid(((size_t)H * PN + kThreads - 1) / kThreads, Bb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reverse)
    ssd_walk_f64<true><<<grid, kThreads, 0, st>>>(
        static_cast<double*>(states), static_cast<const double*>(decay),
        static_cast<const float*>(in), static_cast<float*>(out), (S + Q - 1) / Q, H, PN);
  else
    ssd_walk_f64<false><<<grid, kThreads, 0, st>>>(
        static_cast<double*>(states), static_cast<const double*>(decay),
        static_cast<const float*>(in), static_cast<float*>(out), (S + Q - 1) / Q, H, PN);
  return (int)cudaGetLastError();
}

// the chunk kernel: dx, ddt, dB / dC partials per tile of HT heads (B, S,
// G x ceil((H / G) / HT), N) and per-chunk dA / dD partials (x, B, C, dy, dx
// bf16, 16-byte aligned)
int ssd_bwd_bf16(const void* x, const void* dt, const void* A_log, const void* Bm,
                 const void* Cm, const void* Dp, const void* dy, const void* states,
                 const void* dstates, void* dx, void* ddt, void* dB_part, void* dC_part,
                 void* dA_part, void* dD_part, int Bb, int S, int H, int G, int P, int N,
                 int Q, int HT, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q) || HT < 1 || HT > H / G) return (int)cudaErrorInvalidValue;
  const size_t smem = TileSmem(P, N, Q).bytes;
  const int e = set_smem(ssd_bwd_tile_mma, smem);
  if (e) return e;
  const int tiles = (H / G + HT - 1) / HT;
  ssd_bwd_tile_mma<<<dim3((S + Q - 1) / Q, Bb, G * tiles), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(Dp),
      static_cast<const bf16*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dstates), static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<double*>(dA_part), static_cast<double*>(dD_part), S, H, G, P, N, Q, HT);
  return (int)cudaGetLastError();
}

// The earlier chunk kernel, one block per (chunk, b, head), with per-head
// dB / dC partials (B, S, H, N): on no path of the port, timed beside
// ssd_bwd_bf16.
int ssd_bwd_bf16_per_head(const void* x, const void* dt, const void* A_log, const void* Bm,
                          const void* Cm, const void* Dp, const void* dy, const void* states,
                          const void* dstates, void* dx, void* ddt, void* dB_part,
                          void* dC_part, void* dA_part, void* dD_part, int Bb, int S, int H,
                          int G, int P, int N, int Q, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  const size_t smem = BwdSmem(P, N, Q).bytes;
  const int e = set_smem(ssd_bwd_mma, smem);
  if (e) return e;
  ssd_bwd_mma<<<dim3((S + Q - 1) / Q, Bb, H), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(Dp),
      static_cast<const bf16*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dstates), static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<double*>(dA_part), static_cast<double*>(dD_part), S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

// the same in f32 on the CUDA cores
int ssd_bwd_f32(const void* x, const void* dt, const void* A_log, const void* Bm,
                const void* Cm, const void* Dp, const void* dy, const void* states,
                const void* dstates, void* dx, void* ddt, void* dB_part, void* dC_part,
                void* dA_part, void* dD_part, int Bb, int S, int H, int G, int P, int N,
                int Q, void* stream) {
  if (!shapes_ok(S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_f32_smem(Q);
  const int e = set_smem(ssd_bwd_cuda_cores, smem);
  if (e) return e;
  ssd_bwd_cuda_cores<<<dim3((S + Q - 1) / Q, Bb, H), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(dy), static_cast<const double*>(states),
      static_cast<const double*>(dstates), static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<double*>(dA_part), static_cast<double*>(dD_part), S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

// the fixed-order sums: dB, dC (bf16) over the per_group partials of each
// group (tiles of heads, or heads); dA_log, dD
int ssd_bwd_finish_bf16(const void* dB_part, const void* dC_part, const void* dA_part,
                        const void* dD_part, const void* A_log, void* dB, void* dC,
                        void* dA_log, void* dD, int Bb, int S, int H, int G, int N, int Q,
                        int per_group, void* stream) {
  return launch_finish<bf16>(dB_part, dC_part, dA_part, dD_part, A_log, dB, dC, dA_log, dD,
                             Bb, S, H, G, N, Q, per_group, stream);
}

// the same with f32 dB, dC
int ssd_bwd_finish_f32(const void* dB_part, const void* dC_part, const void* dA_part,
                       const void* dD_part, const void* A_log, void* dB, void* dC,
                       void* dA_log, void* dD, int Bb, int S, int H, int G, int N, int Q,
                       int per_group, void* stream) {
  return launch_finish<float>(dB_part, dC_part, dA_part, dD_part, A_log, dB, dC, dA_log, dD,
                              Bb, S, H, G, N, Q, per_group, stream);
}

}  // extern "C"
