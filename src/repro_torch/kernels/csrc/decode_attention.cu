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
// Bound on the H100: memory. Every valid K and V row is read once and used
// for 2·g·Dh multiply-adds, about g/2 flops per byte in bf16, far below the
// ~295 the tensor cores need per byte. The floor is the valid K/V bytes /
// 3.35 TB/s: 5.0 µs for one llama3.2-1b layer's full (8, 1024, 8, 64) bf16
// cache, 80 µs for a (8, 16384, 8, 64) one.
//
// Design (decode_fused_bf16 / decode_fused_f32, one launch per call). The TPU grid walks (B, H, kv
// chunk) in order with the softmax state in VMEM; here B·H is small at
// decode, so the kv axis is split across blocks too: one 128-thread block
// per (kv split, kv head, b), which reads each K/V row once for the g query
// heads that share it. The wrapper's split plan fills every SM.
//  * Masks first. The block reads its split's kv_pos (8 loads in flight a
//    thread), keeps one bit per row in shared memory and compacts the list
//    of tiles (64 rows) with at least one valid row: a fully masked tile is
//    never requested, and neither is a masked row of a live tile.
//  * K/V streamed through shared memory. Tiles arrive by 16-byte cp.async,
//    a row's 16-byte chunks on neighbouring threads, through a ring of 3-4
//    stages (16-32 KB each), so 32-96 KB are in flight per block while the
//    block computes on the oldest stage.
//  * Math from shared memory. bf16 (the serving path): each warp owns 16 rows
//    of every tile and runs the products on the tensor cores (mma.sync
//    m16n8k16, f32 accumulation): S = Q·Kᵀ with the g query heads as A's
//    rows (padded to 16), an online softmax per head in f32, then P·V with P
//    taken from S's accumulator fragments; K and V come by ldmatrix from
//    row-swizzled chunks. f32: each thread owns one 16-byte chunk of a row
//    group's rows, the g scores are summed by xor-shuffles, and the products
//    stay f32 on the CUDA cores (the f32 tolerance needs them). Either way
//    a thread or warp loads exactly the rows it reads, so the ring needs no
//    block barrier. The CUDA-core form was the first design for both dtypes;
//    at ~1.5 TB/s with K/V warm in L2 its instruction stream, not memory,
//    was the limit in bf16, which is why bf16 moved to mma.sync.
//  * One launch. The row groups' states merge in shared memory. With one
//    split the block writes out. Otherwise it writes its partial (m, l,
//    acc) to the workspace, fences, and counts itself in the (b, kv head)
//    arrival counter; the block that arrives last merges the splits in
//    split order (the result does not depend on the schedule), writes out
//    and resets the counter to 0 for the next call or graph replay.
//
// decode_split + decode_merge (namespace split_merge) are the earlier design
// (one lane per row with 16-byte K loads 1 KB apart, a serial walk of the
// valid rows for P·V, a second launch for the merge). No path of the port
// calls them; chip_smoke.py times them as the yardstick earlier_ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);   // elements per 16-byte load
};

// 16 bytes of T widened to f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  widen<T>(__ldg(reinterpret_cast<const uint4*>(p)), f);
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

// ---------------------------------------------------------------------------
// decode_fused: one launch per call
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;        // 4 warps
constexpr int kBlockWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kMaxTiles = 256;       // tiles per split (split_len <= 16384)
constexpr int kMaxSplits = 512;
constexpr int kPosBatch = 8;         // kv_pos loads in flight per thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;    // the initial running max (finite)

// The fixed head of dynamic shared memory; the K/V ring follows at kRingOff.
constexpr int kMask = 0;                             // u32 [2·kMaxTiles]: row bits
constexpr int kList = kMask + 2 * kMaxTiles * 4;     // i32 [kMaxTiles]: live tiles
constexpr int kMisc = kList + kMaxTiles * 4;         // i32 [4], then f32 head_m/l [2·8]
constexpr int kRingOff = kMisc + 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* kv_pos;
  void* out;
  float* part_ml;       // (B·H·n_split, 2): m, l of each split
  float* part_acc;      // (B·H·n_split, Dh)
  int* counters;        // (B·Hkv) arrivals, 0 between launches
  int S, H, Hkv, Dh, causal, window, split_len;
  float scale_log2;     // Dh^-0.5 · log2 e
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16) · b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Steps 1-2 of every instance: one bit per row of the split (32 rows a word)
// and the in-order list of the tiles with a valid row → their count.
__device__ __forceinline__ int live_tiles(const Args& a, int b, int s_begin, int n_rows,
                                          unsigned char* smem) {
  uint32_t* mask32 = reinterpret_cast<uint32_t*>(smem + kMask);
  int* tile_list = reinterpret_cast<int*>(smem + kList);
  int* misc = reinterpret_cast<int*>(smem + kMisc);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int qp = a.q_pos[b];
  const int32_t* kp = a.kv_pos + (size_t)b * a.S + s_begin;
  for (int base = 0; base < n_rows; base += kThreads * kPosBatch) {
    int p[kPosBatch];
#pragma unroll
    for (int j = 0; j < kPosBatch; ++j) {
      const int r = base + j * kThreads + tid;
      p[j] = r < n_rows ? __ldg(kp + r) : -1;
    }
#pragma unroll
    for (int j = 0; j < kPosBatch; ++j) {
      const bool ok = p[j] >= 0 && (!a.causal || p[j] <= qp) &&
                      (a.window <= 0 || qp - p[j] < a.window);
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      const int word = (base + j * kThreads) / 32 + warp;
      if (lane == 0 && word < 2 * n_tiles) mask32[word] = bal;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int t = base + lane;
      const bool live = t < n_tiles && (mask32[2 * t] | mask32[2 * t + 1]) != 0u;
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) tile_list[count + __popc(bal & ((1u << lane) - 1u))] = t;
      count += __popc(bal);
    }
    if (lane == 0) misc[0] = count;
  }
  __syncthreads();
  return misc[0];
}

__device__ __forceinline__ uint64_t tile_bits(const unsigned char* smem, int t) {
  const uint32_t* mask32 = reinterpret_cast<const uint32_t*>(smem + kMask);
  return (uint64_t)mask32[2 * t] | ((uint64_t)mask32[2 * t + 1] << 32);
}

// Steps 4-5 of every instance, after each of the RG row groups put its
// state in the ring: m, l [RG][GP] and acc [RG][GP][DP] (head dims padded
// to DP). Merge the groups; with one split write out, else write the
// split's partial, count the arrival, and let the last block of the
// (b, kv head) merge the splits in order and reset the counter.
template <typename T, int RG, int GP, int DP>
__device__ __forceinline__ void finish(const Args& a, int b, int kvh, int split,
                                       unsigned char* smem) {
  const float* r_acc = reinterpret_cast<const float*>(smem + kRingOff);
  const float* r_m = r_acc + RG * GP * DP;
  const float* r_l = r_m + RG * GP;
  float* r_w = const_cast<float*>(r_l) + RG * GP;
  int* misc = reinterpret_cast<int*>(smem + kMisc);
  float* head_l = reinterpret_cast<float*>(misc + 4);         // [GP]
  float* head_m = head_l + GP;                                 // [GP]
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x;
  const int n_split = gridDim.x;
  const int g = a.H / a.Hkv, Dh = a.Dh;
  if (tid < g) {
    const int j = tid;
    float M = kNegBig;
    for (int i = 0; i < RG; ++i) M = fmaxf(M, r_m[i * GP + j]);
    float Lsum = 0.f;
    for (int i = 0; i < RG; ++i) {
      const float w = ex2(r_m[i * GP + j] - M);
      r_w[i * GP + j] = w;
      Lsum += r_l[i * GP + j] * w;
    }
    head_m[j] = M;
    head_l[j] = Lsum;
  }
  __syncthreads();
  const size_t bh0 = (size_t)b * a.H + (size_t)kvh * g;       // first head of the group
  for (int i = tid; i < g * Dh; i += kThreads) {
    const int j = i / Dh, d = i - j * Dh;
    float A = 0.f;
#pragma unroll
    for (int x = 0; x < RG; ++x) A += r_acc[(x * GP + j) * DP + d] * r_w[x * GP + j];
    if (n_split == 1) {
      store(&out[(bh0 + j) * Dh + d], A / fmaxf(head_l[j], 1e-30f));
    } else {
      const size_t o = (bh0 + j) * n_split + split;
      a.part_acc[o * Dh + d] = A;
      if (d == 0) {
        a.part_ml[2 * o] = head_m[j];
        a.part_ml[2 * o + 1] = head_l[j];
      }
    }
  }
  if (n_split == 1) return;

  // the barrier orders every thread's partial before thread 0's fence and
  // arrival (as a grid barrier does); the last block fences before it reads
  __syncthreads();
  int* counter = a.counters + (size_t)b * a.Hkv + kvh;
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == n_split - 1;
    if (last) __threadfence();
    misc[1] = last;
  }
  __syncthreads();
  if (!misc[1]) return;
  for (int i = tid; i < g * Dh; i += kThreads) {       // splits in order, one pass
    const int j = i / Dh, d = i - j * Dh;
    const float* ml = a.part_ml + 2 * (bh0 + j) * n_split;
    const float* pa = a.part_acc + (bh0 + j) * n_split * Dh + d;
    float M = kNegBig, Lsum = 0.f, A = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = __ldcg(ml + 2 * sp), ls = __ldcg(ml + 2 * sp + 1);
      const float as = __ldcg(pa + (size_t)sp * Dh);
      if (ms > M) {
        const float corr = ex2(M - ms);
        Lsum *= corr;
        A *= corr;
        M = ms;
      }
      const float w = ex2(ms - M);
      Lsum += ls * w;
      A += as * w;
    }
    store(&out[(bh0 + j) * Dh + d], A / fmaxf(Lsum, 1e-30f));
  }
  if (tid == 0) *counter = 0;
}

// The ring: NS stages of a K tile then a V tile, kTileRows rows of NCP
// 16-byte chunks each.
template <int NCP>
struct Ring {
  static constexpr int kRow = NCP * 16;
  static constexpr int kTile = kTileRows * kRow;
  static constexpr int kStages = 2 * kTile <= 16384 ? 4 : 3;
  static constexpr int kBytes = kStages * 2 * kTile;
};

// ---- f32: CUDA cores --------------------------------------------------------
//
// Thread (row group rg, chunk c) owns head dims [4c, 4c + 4) of rows rg, rg +
// RG, ... of each tile and loads exactly those chunks itself, so the ring
// needs no block barrier. Its g partial scores are summed over the row's
// chunk threads by xor-shuffles; then every chunk thread of a row holds the
// row's scores and keeps its own online softmax state per head.

template <int NCP, int GP>
struct Fused {
  static constexpr int V = 4;
  static constexpr int RG = kThreads / NCP;                  // row groups
  static constexpr int RPT = kTileRows / RG;                 // rows per thread per tile
  static constexpr int RB = (GP >= 8 || RPT < 4) ? (RPT < 2 ? RPT : 2) : 4;   // rows per batch
  static constexpr int kMerge = RG * GP * (NCP * V + 3) * 4; // acc, m, l, weight
  static constexpr int kBytes =
      kRingOff + (Ring<NCP>::kBytes > kMerge ? Ring<NCP>::kBytes : kMerge);
};

template <int NCP, int GP>
__global__ void __launch_bounds__(kThreads) decode_fused_f32(Args a) {
  using L = Fused<NCP, GP>;
  using R = Ring<NCP>;
  constexpr int V = L::V, RG = L::RG, RPT = L::RPT, RB = L::RB, NS = R::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + kRingOff;
  const int* tile_list = reinterpret_cast<const int*>(smem + kList);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv, Dh = a.Dh, NC = Dh / V;
  const int tid = threadIdx.x;
  const int c = tid % NCP, rg = tid / NCP;
  const bool live_c = c < NC;
  const int s_begin = split * a.split_len;
  const int n_rows = min(a.S, s_begin + a.split_len) - s_begin;

  float qr[GP][V];                   // in flight during the mask pass
  const float* q = static_cast<const float*>(a.q);
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    if (j < g && live_c) {
      load16(q + ((size_t)b * a.H + kvh * g + j) * Dh + c * V, qr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qr[j][e] = 0.f;
    }
  }
  const int n_live = live_tiles(a, b, s_begin, n_rows, smem);

  const size_t row_stride = (size_t)a.Hkv * Dh;
  const float* kbase = static_cast<const float*>(a.k) + ((size_t)b * a.S + s_begin) * row_stride +
                       (size_t)kvh * Dh;
  const float* vbase = static_cast<const float*>(a.v) + ((size_t)b * a.S + s_begin) * row_stride +
                       (size_t)kvh * Dh;
  auto fetch = [&](int li) {         // an empty group past the end keeps the counts
    if (li < n_live) {
      const int t = tile_list[li];
      const uint64_t tm = tile_bits(smem, t);
      unsigned char* ks = ring + (li % NS) * 2 * R::kTile;
      unsigned char* vs = ks + R::kTile;
#pragma unroll
      for (int it = 0; it < RPT; ++it) {
        const int r = rg + RG * it;
        if (live_c && ((tm >> r) & 1ull)) {
          const size_t off = (size_t)(t * kTileRows + r) * row_stride + c * V;
          cp_async16(ks + r * R::kRow + c * 16, kbase + off, 16);
          cp_async16(vs + r * R::kRow + c * 16, vbase + off, 16);
        }
      }
    }
    cp_async_commit();
  };

  float m[GP], l[GP], acc[GP][V];
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    m[j] = kNegBig;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int li = 0; li < NS - 1; ++li) fetch(li);

  for (int li = 0; li < n_live; ++li) {
    cp_async_wait<NS - 2>();         // this thread's chunks of stage li landed
    fetch(li + NS - 1);              // into the stage read at li - 1
    const uint64_t tm = tile_bits(smem, tile_list[li]);
    const unsigned char* ks = ring + (li % NS) * 2 * R::kTile;
    const unsigned char* vs = ks + R::kTile;
#pragma unroll
    for (int r0 = 0; r0 < RPT; r0 += RB) {
      float sc[RB][GP];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int r = rg + RG * (r0 + rr);
        float kf[V];
        if (live_c) {
          widen<float>(*reinterpret_cast<const uint4*>(ks + r * R::kRow + c * 16), kf);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < GP; ++j) {
          float sj = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) sj += qr[j][e] * kf[e];
          sc[rr][j] = sj;
        }
      }
#pragma unroll
      for (int o = NCP / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
#pragma unroll
          for (int j = 0; j < GP; ++j) sc[rr][j] += __shfl_xor_sync(0xffffffffu, sc[rr][j], o);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const bool valid = (tm >> (rg + RG * (r0 + rr))) & 1ull;
#pragma unroll
        for (int j = 0; j < GP; ++j) sc[rr][j] = valid ? sc[rr][j] * a.scale_log2 : -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < GP; ++j) {
        float mx = sc[0][j];
#pragma unroll
        for (int rr = 1; rr < RB; ++rr) mx = fmaxf(mx, sc[rr][j]);
        if (mx > m[j]) {
          const float corr = ex2(m[j] - mx);
          l[j] *= corr;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[j][e] *= corr;
          m[j] = mx;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int r = rg + RG * (r0 + rr);
        if (live_c && ((tm >> r) & 1ull)) {
          float vf[V];
          widen<float>(*reinterpret_cast<const uint4*>(vs + r * R::kRow + c * 16), vf);
#pragma unroll
          for (int j = 0; j < GP; ++j) {
            const float p = ex2(sc[rr][j] - m[j]);
            l[j] += p;
#pragma unroll
            for (int e = 0; e < V; ++e) acc[j][e] += p * vf[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the merge

  constexpr int DP = NCP * V;
  float* r_acc = reinterpret_cast<float*>(ring);
  float* r_m = r_acc + RG * GP * DP;
  float* r_l = r_m + RG * GP;
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    if (c == 0) {
      r_m[rg * GP + j] = m[j];
      r_l[rg * GP + j] = l[j];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) r_acc[(rg * GP + j) * DP + c * V + e] = acc[j][e];
  }
  __syncthreads();
  finish<float, RG, GP, DP>(a, b, kvh, split, smem);
}

// ---- bf16: tensor cores (mma.sync) --------------------------------------------
//
// Warp w owns rows [16w, 16w + 16) of each tile and loads exactly those (a
// masked row or a padding chunk arrives as zeros, without a read), so the
// ring needs only warp barriers. Per tile the warp computes S = Q·Kᵀ for its
// 16 rows with the g query heads as the rows of A (padded to 16; q stays in
// registers as A fragments), keeps an online softmax per head in the log2
// domain, and accumulates P·V with P taken from S's accumulator fragments as
// the next A operand: 2·NCP mma.sync a tile, K by ldmatrix and V by
// ldmatrix.trans from 16-byte chunks swizzled by row (conflict-free).

template <int NCP>
struct Mma {
  static constexpr int DP = NCP * 8;                         // padded head dim
  static constexpr int RG = kBlockWarps;                         // row groups = warps
  static constexpr int GP = 8;
  static constexpr int kMerge = RG * GP * (DP + 3) * 4;
  static constexpr int kBytes =
      kRingOff + (Ring<NCP>::kBytes > kMerge ? Ring<NCP>::kBytes : kMerge);
};

// Byte offset of chunk c of row r in a tile: chunks xor-swizzled by row so
// that 8 rows at one chunk fall in 8 different 16-byte bank groups.
template <int NCP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kMaskC = NCP >= 8 ? 7 : NCP - 1;
  return r * (NCP * 16) + ((c & ~kMaskC) | ((c ^ r) & kMaskC)) * 16;
}

template <int NCP>
__global__ void __launch_bounds__(kThreads) decode_fused_bf16(Args a) {
  using R = Ring<NCP>;
  constexpr int NS = R::kStages, KS = NCP / 2, DP = Mma<NCP>::DP;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + kRingOff;
  const int* tile_list = reinterpret_cast<const int*>(smem + kList);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv, Dh = a.Dh, NC = Dh / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;    // fragment row (head) and column pair
  const int s_begin = split * a.split_len;
  const int n_rows = min(a.S, s_begin + a.split_len) - s_begin;

  // A fragments of Q (row gr = head, 16 head dims per k-step); rows 8-15 are 0
  uint32_t qa[KS][2];
  {
    const uint32_t* q = static_cast<const uint32_t*>(a.q) +
                        (((size_t)b * a.H + kvh * g + gr) * Dh) / 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int d0 = 16 * ks + 2 * tq;
      qa[ks][0] = gr < g && d0 < Dh ? __ldg(q + d0 / 2) : 0u;
      qa[ks][1] = gr < g && d0 + 8 < Dh ? __ldg(q + (d0 + 8) / 2) : 0u;
    }
  }
  const int n_live = live_tiles(a, b, s_begin, n_rows, smem);

  const size_t row_stride = (size_t)a.Hkv * Dh;
  const __nv_bfloat16* kbase = static_cast<const __nv_bfloat16*>(a.k) +
                               ((size_t)b * a.S + s_begin) * row_stride + (size_t)kvh * Dh;
  const __nv_bfloat16* vbase = static_cast<const __nv_bfloat16*>(a.v) +
                               ((size_t)b * a.S + s_begin) * row_stride + (size_t)kvh * Dh;
  // this lane's chunks of the warp's rows: row 16w + lane / NCP + i·(32 / NCP)
  constexpr int kRowsPerPass = 32 / NCP;
  const int lc = lane % NCP, lr = lane / NCP;
  auto fetch = [&](int li) {
    if (li < n_live) {
      const int t = tile_list[li];
      const uint32_t bits = (uint32_t)(tile_bits(smem, t) >> (16 * warp)) & 0xFFFFu;
      unsigned char* ks = ring + (li % NS) * 2 * R::kTile;
      unsigned char* vs = ks + R::kTile;
      if (bits) {
#pragma unroll
        for (int i = 0; i < 16 / kRowsPerPass; ++i) {
          const int rw = lr + i * kRowsPerPass;              // row within the warp's 16
          const int r = 16 * warp + rw;
          const bool ok = lc < NC && ((bits >> rw) & 1u);
          const size_t off = ok ? (size_t)(t * kTileRows + r) * row_stride + lc * 8 : 0;
          cp_async16(ks + swz<NCP>(r, lc), kbase + off, ok ? 16 : 0);
          cp_async16(vs + swz<NCP>(r, lc), vbase + off, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float m = kNegBig, l = 0.f;        // head gr (rows 8-15 of the fragments are padding)
  float acc[NCP][2];                 // out[gr][8·nb + 2·tq + {0, 1}]
#pragma unroll
  for (int nb = 0; nb < NCP; ++nb) acc[nb][0] = acc[nb][1] = 0.f;
#pragma unroll
  for (int li = 0; li < NS - 1; ++li) fetch(li);

  for (int li = 0; li < n_live; ++li) {
    cp_async_wait<NS - 2>();
    __syncwarp();                    // the warp's rows of stage li landed; li - 1 read
    fetch(li + NS - 1);
    const uint32_t bits =
        (uint32_t)(tile_bits(smem, tile_list[li]) >> (16 * warp)) & 0xFFFFu;
    if (!bits) continue;             // the warp's 16 rows are all masked
    const unsigned char* ks = ring + (li % NS) * 2 * R::kTile;
    const unsigned char* vs = ks + R::kTile;
    // S = Q·Kᵀ: n-block nb holds kv rows 16w + 8nb + 2tq + {0, 1}
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;                              // matrix of ldmatrix.x4
      const int r = 16 * warp + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];              // (nb 0, k lo), (nb 0, k hi), (nb 1, k lo), (nb 1, k hi)
        ldmatrix_x4(kb, ks + swz<NCP>(r, 2 * kk + (mi & 1)));
        mma_bf16(s[0], qa[kk][0], 0u, qa[kk][1], 0u, kb[0], kb[1]);
        mma_bf16(s[1], qa[kk][0], 0u, qa[kk][1], 0u, kb[2], kb[3]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rw = 8 * nb + 2 * tq + e;
        s[nb][e] = (bits >> rw) & 1u ? s[nb][e] * a.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[nb][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (mx > m) {
      const float corr = ex2(m - mx);
      l *= corr;
#pragma unroll
      for (int nb = 0; nb < NCP; ++nb) {
        acc[nb][0] *= corr;
        acc[nb][1] *= corr;
      }
      m = mx;
    }
    float p[2][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      p[nb][0] = ex2(s[nb][0] - m);
      p[nb][1] = ex2(s[nb][1] - m);
      l += p[nb][0] + p[nb][1];
    }
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
    // acc += P·V: n-block nb = head dims 8nb..8nb+7, k = the warp's 16 rows
    {
      const int mi = lane >> 3;
      const int r = 16 * warp + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int nb = 0; nb < NCP; nb += 2) {
        uint32_t vb[4];              // (nb, k lo), (nb, k hi), (nb + 1, k lo), (nb + 1, k hi)
        ldmatrix_x4_trans(vb, vs + swz<NCP>(r, nb + (mi >> 1)));
        float d0[4] = {acc[nb][0], acc[nb][1], 0.f, 0.f};
        float d1[4] = {acc[nb + 1][0], acc[nb + 1][1], 0.f, 0.f};
        mma_bf16(d0, pa0, 0u, pa2, 0u, vb[0], vb[1]);
        mma_bf16(d1, pa0, 0u, pa2, 0u, vb[2], vb[3]);
        acc[nb][0] = d0[0];
        acc[nb][1] = d0[1];
        acc[nb + 1][0] = d1[0];
        acc[nb + 1][1] = d1[1];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the merge

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  constexpr int RG = Mma<NCP>::RG, GP = Mma<NCP>::GP;
  float* r_acc = reinterpret_cast<float*>(ring);
  float* r_m = r_acc + RG * GP * DP;
  float* r_l = r_m + RG * GP;
  if (tq == 0) {
    r_m[warp * GP + gr] = m;
    r_l[warp * GP + gr] = l;
  }
#pragma unroll
  for (int nb = 0; nb < NCP; ++nb) {
    r_acc[(warp * GP + gr) * DP + 8 * nb + 2 * tq] = acc[nb][0];
    r_acc[(warp * GP + gr) * DP + 8 * nb + 2 * tq + 1] = acc[nb][1];
  }
  __syncthreads();
  finish<__nv_bfloat16, RG, GP, DP>(a, b, kvh, split, smem);
}

// Launch an instance (or, with blocks_per_sm, ask for its occupancy).
template <typename K>
int launch_inst(K kernel, int smem, std::atomic<unsigned long long>& smem_set, const Args& a,
                int B, int n_split, cudaStream_t st, int* blocks_per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!((smem_set.load() >> dev) & 1ull)) {   // once, so a graph capture makes no such call
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set.fetch_or(1ull << dev);
  }
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                              smem);
  kernel<<<dim3(n_split, a.Hkv, B), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NCP, int GP>
int launch_f32(const Args& a, int B, int n_split, cudaStream_t st, int* blocks_per_sm) {
  static std::atomic<unsigned long long> smem_set{0};   // one bit per device
  return launch_inst(decode_fused_f32<NCP, GP>, Fused<NCP, GP>::kBytes, smem_set, a, B,
                     n_split, st, blocks_per_sm);
}

template <int NCP>
int launch_bf16(const Args& a, int B, int n_split, cudaStream_t st, int* blocks_per_sm) {
  static std::atomic<unsigned long long> smem_set{0};
  return launch_inst(decode_fused_bf16<NCP>, Mma<NCP>::kBytes, smem_set, a, B, n_split, st,
                     blocks_per_sm);
}

template <int NCP>
int launch_f32_g(int g, const Args& a, int B, int n_split, cudaStream_t st, int* bps) {
  if (g <= 1) return launch_f32<NCP, 1>(a, B, n_split, st, bps);
  if (g <= 2) return launch_f32<NCP, 2>(a, B, n_split, st, bps);
  if (g <= 4) return launch_f32<NCP, 4>(a, B, n_split, st, bps);
  return launch_f32<NCP, 8>(a, B, n_split, st, bps);
}

// Dispatch on the 16-byte chunks per row, rounded up to a power of two (at
// least 2), and for f32 on g rounded up; blocks_per_sm != nullptr asks for
// the instance's occupancy instead of a launch.
int launch_fused(bool bf16, const Args& a, int B, int n_split, void* stream,
                 int* blocks_per_sm) {
  const int V = bf16 ? 8 : 4;
  const int nc = a.Dh / V, g = a.H / a.Hkv;
  if (a.Dh % V || nc < 1 || a.Dh > 128 || g < 1 || g > 8 || a.H % a.Hkv ||
      a.split_len % kTileRows || a.split_len > kMaxTiles * kTileRows || n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ncp = 2;
  while (ncp < nc) ncp *= 2;
  if (bf16) {
    switch (ncp) {
      case 2: return launch_bf16<2>(a, B, n_split, st, blocks_per_sm);
      case 4: return launch_bf16<4>(a, B, n_split, st, blocks_per_sm);
      case 8: return launch_bf16<8>(a, B, n_split, st, blocks_per_sm);
      case 16: return launch_bf16<16>(a, B, n_split, st, blocks_per_sm);
    }
  } else {
    switch (ncp) {
      case 2: return launch_f32_g<2>(g, a, B, n_split, st, blocks_per_sm);
      case 4: return launch_f32_g<4>(g, a, B, n_split, st, blocks_per_sm);
      case 8: return launch_f32_g<8>(g, a, B, n_split, st, blocks_per_sm);
      case 16: return launch_f32_g<16>(g, a, B, n_split, st, blocks_per_sm);
      case 32: return launch_f32_g<32>(g, a, B, n_split, st, blocks_per_sm);
    }
  }
  return (int)cudaErrorInvalidValue;
}

int launch_fused_c(bool bf16, const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, void* out, void* part_ml, void* part_acc,
                   void* counters, int B, int S, int H, int Hkv, int Dh, int causal,
                   int window, int split_len, int n_split, float scale, void* stream) {
  const Args a{q, k, v, static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(kv_pos),
               out, static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               static_cast<int*>(counters), S, H, Hkv, Dh, causal, window, split_len,
               scale * kLog2e};
  return launch_fused(bf16, a, B, n_split, stream, nullptr);
}

// ---------------------------------------------------------------------------
// split_merge: the earlier design, kept as the yardstick
// ---------------------------------------------------------------------------

namespace split_merge {

constexpr int kWarps = 4;
constexpr int kTile = 32;       // kv rows per warp step, one per lane
constexpr int kMaxG = 8;        // query heads per kv head
constexpr int kMaxDh = 128;
constexpr int kMaxDpl = kMaxDh / 32;   // head dims per lane in P·V
constexpr float kNegInf = -1e30f;

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

}  // namespace split_merge

}  // namespace

extern "C" {

// q (B,1,H,Dh), k/v (B,S,Hkv,Dh) f32 (16-byte aligned, Dh a multiple of 4,
// at most 128), q_pos (B,) i32, kv_pos (B,S) i32 → out (B,1,H,Dh); H/Hkv <= 8.
// split_len is a multiple of 64 rows (at most 16384) and n_split =
// ceil(S / split_len) <= 512. part_ml (B·H·n_split·2) and part_acc
// (B·H·n_split·Dh) are f32 workspace; counters (B·Hkv) int32 are 0 on entry
// and are 0 again when the kernel ends. window <= 0 means no window.
int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* kv_pos, void* out,
                         void* part_ml, void* part_acc, void* counters, int B, int S,
                         int H, int Hkv, int Dh, int causal, int window, int split_len,
                         int n_split, float scale, void* stream) {
  return launch_fused_c(false, q, k, v, q_pos, kv_pos, out, part_ml, part_acc, counters, B,
                        S, H, Hkv, Dh, causal, window, split_len, n_split, scale, stream);
}

// The same for bf16 q/k/v/out (Dh a multiple of 8): the products on the
// tensor cores with f32 accumulation, the softmax state in f32.
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* q_pos, const void* kv_pos, void* out,
                          void* part_ml, void* part_acc, void* counters, int B, int S,
                          int H, int Hkv, int Dh, int causal, int window, int split_len,
                          int n_split, float scale, void* stream) {
  return launch_fused_c(true, q, k, v, q_pos, kv_pos, out, part_ml, part_acc, counters, B,
                        S, H, Hkv, Dh, causal, window, split_len, n_split, scale, stream);
}

// → *blocks_per_sm: how many blocks of the instance for (bf16, Dh, g) fit on
// one SM at once (the split plan's slots are this times the SM count).
int decode_attention_blocks_per_sm(int bf16, int Dh, int g, int* blocks_per_sm) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, 1, g, 1, Dh, 1, 0, kTileRows, 1.f};
  return launch_fused(bf16 != 0, a, 1, 1, nullptr, blocks_per_sm);
}

// The earlier design, two launches (decode_split, decode_merge); split_len a
// multiple of 128. Not on any path of the port: chip_smoke.py's yardstick.
int decode_attention_split_merge_f32(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* kv_pos, void* out,
                                     void* part_ml, void* part_acc, int B, int S, int H,
                                     int Hkv, int Dh, int causal, int window, int split_len,
                                     int n_split, float scale, void* stream) {
  return split_merge::launch<float>(q, k, v, q_pos, kv_pos, out, part_ml, part_acc, B, S,
                                    H, Hkv, Dh, causal, window, split_len, n_split, scale,
                                    stream);
}

int decode_attention_split_merge_bf16(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* kv_pos, void* out,
                                      void* part_ml, void* part_acc, int B, int S, int H,
                                      int Hkv, int Dh, int causal, int window,
                                      int split_len, int n_split, float scale,
                                      void* stream) {
  return split_merge::launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, part_ml,
                                            part_acc, B, S, H, Hkv, Dh, causal, window,
                                            split_len, n_split, scale, stream);
}

}  // extern "C"
