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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// 2^x; exactly 0 for x = -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// 1. chunk states s_c = (w⊙x)ᵀ·B and decays exp(cum_Q), per (chunk, b, head)
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
    for (int e = 0; e < kMaxQ / 32; ++e)
      if (e < per) wv[e] = expf((float)(total - cum[e])) * wr[lane * per + e];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e)
      if (e < per) wr[lane * per + e] = wv[e];
    if (lane == 0) decay[((size_t)b * nc + c) * H + h] = expf((float)total);
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
  const size_t smem = states_smem(P, N, Q, HT);
  cudaError_t e = cudaFuncSetAttribute(ssd_states_mma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + Q - 1) / Q, Bb, H / HT);
  ssd_states_mma<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<float*>(states), static_cast<float*>(decay), S, H, G, P, N, Q, HT);
  return (int)cudaGetLastError();
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

}  // extern "C"
