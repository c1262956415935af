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
// (A_log = log(1..64), Q = 128).
//
// Bound on the H100: operations, modestly. Per chunk and head the work is
// ~2·Q²·N (C·Bᵀ) + Q²·P + 2·Q·N·P (inter term and state carry) multiply-adds
// against Q·(P + 2N) input elements read once, ~50 flops per byte in bf16 at
// (P, N, Q) = (64, 128, 128): above the memory line of the CUDA cores,
// below the tensor cores'. This first version runs in f32 on the CUDA cores.
//
// Design. The TPU grid (B, H, nc) carries the (P, N) state across chunks in
// VMEM. Here one block of 256 threads owns one (b, h) and walks its chunks in
// order with the state in shared memory: the chunk's x, B, C tiles (f32), the
// state and one 32-row block of the masked Q×Q matrix fit in ~215 KB of
// dynamic shared memory at (64, 128, 128). Per chunk: warp 0 scans the
// decays; then for each 32-row block, C·Bᵀ for the columns j ≤ i only (the
// causal half), its masked weights, then y = att·x + exp(cum)·C·Sᵀ + D·x;
// finally the state carry. A ragged last chunk loads zeros for the steps
// past S (dt = 0: identity steps) and stores only the rows < S, so nothing
// is padded on the host. The chunk-parallel form is for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The same with bf16 x, B, C and y (the scan itself stays f32).
int ssd_scan_bf16(const void* x, const void* dt, const void* A_log, const void* Bm,
                  const void* Cm, const void* Dp, const void* init, void* y,
                  void* final_state, int Bb, int S, int H, int G, int P, int N,
                  int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, Dp, init, y, final_state,
                               Bb, S, H, G, P, N, Q, stream);
}

}  // extern "C"
