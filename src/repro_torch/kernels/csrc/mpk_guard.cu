// mpk_guard.cu — the MPKLink guard MAC family for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mpk_guard.py:
//   guard_copy_pallas (:93)   copy + tag-seeded 128-lane Horner MAC + check
//   mac_batch_pallas  (:153)  N independent MACs in one launch
//   mac_update_pallas (:241)  advance a Horner state over a block,
//   with mac_init_state (:203) and mac_finalize (:271) beside it.
//
// The MAC: h_l = h0·P^n + Σ_r row_{r,l}·P^(n-1-r) per lane l (h0 = INIT+tag,
// or the carried state for mac_update), folded to one word as
// Σ_l h_l·P^(127-l), everything mod 2^32.
//
// Bound on the H100: memory. Each payload word is read once (and written
// once by guard_copy) and costs one 32-bit multiply-add, far below the
// card's integer rate, so the floor is bytes / 3.35 TB/s.
//
// Design. The Pallas grid carries one Horner state across row tiles in
// order; blocks on a GPU run in no order, so that schedule is not carried
// over. The closed form above is linear in the rows, so each block takes a
// chunk of rows, runs Horner over it per lane and scales its partial by
// P^(rows after the chunk) with square-and-multiply. Partials combine by
// wrapping uint32 adds, which are associative and commutative, so the
// result is bit-exact under any schedule; the seed term h0·P^n is added
// once. For the folded MACs each block folds its lanes before writing (the
// fold is linear too). Rows are never padded, since padding would change
// the MAC.
//
// guard_copy (guard_copy_fused, one launch): a 128-thread block per chunk
// of 128 rows, a warp per 512-byte row and 4 lanes per thread, so every
// load and store is 16 bytes; each warp walks its quarter of the chunk,
// loading 8 rows ahead of its Horner steps and writing the copy as it goes.
// (Measured on the H100 at 64 MiB: a software-pipelined loop, 8 warps a
// block, chunks of 256-2048 rows, or the chunk staged through shared memory
// by cp.async.bulk and written back by a bulk store were none faster.)
// A payload of one chunk (the one-row frames of the main path, and the
// zero-row ones) is finished by its block: MAC, seed term, ok. Otherwise
// each block writes its folded word, fences and counts itself in an
// arrival counter; the last block sums the words, adds the seed term,
// writes mac and ok and resets the counter to 0 for the next call or graph
// replay.
//
// mac_update (mac_update_fused) and mac_batch (mac_batch_fused), one launch
// each, in the same layout: a thread owns 4 lanes (16-byte loads, .cs), a
// warp one 512-byte row, and the W warps of a block split its chunk of
// rows into W runs, each loading 8 rows ahead of its Horner steps. Chunks
// are 256 rows and W is one warp per 8 rows of a chunk, 4 to 16
// (MAC_CHUNK_ROWS, mac_threads in kernels/mpk_guard.py): the best of
// chunks 64-1024 x 128-512 threads in a sweep on the H100 at 32 MiB, cold
// in L2 (launch/mac_sweep.py; PERF.md), where one-row calls also ran
// faster with 4 warps than with 16. In probes, loading 16 rows ahead, ld.nc
// or an L2 prefetch hint moved nothing by more than the spread.
// mac_update returns the 128-lane state, so its blocks keep unfolded
// per-lane partials: each warp's run scaled by P^(rows after it), summed
// per lane over the warps through shared memory. A call of one chunk (the
// main path's one-row frames; zero rows return the state) writes h·P^m +
// partial itself. Otherwise each block adds its 128 words into a 128-word
// accumulator with wrapping atomics (bit-exact in any order), fences and
// counts itself; the last block takes the accumulator with atomicExch,
// leaving it 0, adds h·P^m and resets the counter. The accumulator sits
// beside the counter in the workspace's zeroed words. In a probe on the
// H100 at 65,536 rows, per-chunk partials summed in parallel by the last
// block (16 warps over the chunks, 8 loads in flight) left a tail that the
// atomics, which arrive spread over the run, did not.
// mac_batch's grid is (chunk, frame); each block folds its lanes before
// writing one word (the fold is linear too), a frame of one chunk is
// finished by its block with the folded seed term, and a frame of many has
// its own arrival counter, whose last block sums the frame's words.
// The earlier designs stay as chip_smoke.py's yardsticks, and the two MACs
// as the legacy copy plane's (framing.ZERO_COPY = False):
// mpk_guard_copy_two_pass, mpk_mac_update_two_pass and
// mpk_mac_batch_two_pass (one thread per lane, 4-byte accesses, 64-row
// chunks, and a second launch that sums the partials, serially per lane
// in lane_finish).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr uint32_t kPrime = 0x01000193u;
constexpr uint32_t kInit = 0x811C9DC5u;

__device__ __forceinline__ uint32_t pow32(uint32_t base, unsigned long long e) {
  uint32_t r = 1u;
  while (e) {
    if (e & 1ull) r *= base;
    base *= base;
    e >>= 1;
  }
  return r;
}

__device__ __forceinline__ uint32_t fold_power(int lane) {
  return pow32(kPrime, (unsigned long long)(kLanes - 1 - lane));
}

// Wrapping sum of one uint32 per thread over the block (red: a word per
// warp); the result is valid in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0u;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Σ_{r in [r0, r1)} x_{r,lane}·P^(n-1-r) for this thread's lane; copies the
// rows to `out` when it is not null.
__device__ __forceinline__ uint32_t chunk_partial(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    long long r0, long long r1, long long n, int lane) {
  uint32_t acc = 0u;
  const uint32_t* p = in + r0 * kLanes + lane;
  if (out != nullptr) {
    uint32_t* q = out + r0 * kLanes + lane;
#pragma unroll 8
    for (long long r = r0; r < r1; ++r) {
      const uint32_t x = __ldg(p);
      *q = x;
      acc = acc * kPrime + x;
      p += kLanes;
      q += kLanes;
    }
  } else {
#pragma unroll 8
    for (long long r = r0; r < r1; ++r) {
      acc = acc * kPrime + __ldg(p);
      p += kLanes;
    }
  }
  return acc * pow32(kPrime, (unsigned long long)(n - r1));
}

// (Σ_{e<128} P^e) mod 2^32: folds a state whose 128 lanes are equal.
constexpr uint32_t fold_sum(int e, uint32_t p, uint32_t s) {
  return e == kLanes ? s : fold_sum(e + 1, p * kPrime, s + p);
}
constexpr uint32_t kFoldSum = fold_sum(0, 1u, 0u);

constexpr int kGuardThreads = 128;   // 4 warps, one 512-byte row per warp step
constexpr int kAhead = 8;            // rows a thread loads before its Horner steps

__device__ __forceinline__ void horner4(uint4& a, const uint4& x) {
  a.x = a.x * kPrime + x.x;
  a.y = a.y * kPrime + x.y;
  a.z = a.z * kPrime + x.z;
  a.w = a.w * kPrime + x.w;
}

// Copy rows [r0, r1) of this thread's 4 lanes (16 bytes at column t; the
// payload is read and written once, so both bypass the caches' keep
// policy: ld/st .cs) and return Σ_r Σ_i x_{r,4t+i}·P^(n-1-r)·P^(127-4t-i), its share of the folded
// MAC.
__device__ __forceinline__ uint32_t quad_partial(const uint4* __restrict__ in,
                                                 uint4* __restrict__ out, long long r0,
                                                 long long r1, long long n, int t) {
  uint4 a = make_uint4(0u, 0u, 0u, 0u);
  long long r = r0;
  for (; r + kAhead <= r1; r += kAhead) {
    uint4 x[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) x[i] = __ldcs(in + (r + i) * 32 + t);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      __stcs(out + (r + i) * 32 + t, x[i]);
      horner4(a, x[i]);
    }
  }
  for (; r < r1; ++r) {
    const uint4 x = __ldcs(in + r * 32 + t);
    __stcs(out + r * 32 + t, x);
    horner4(a, x);
  }
  // fold the 4 lanes (lane 4t+3 has the lowest power) and scale to the end
  const uint32_t w = ((a.x * kPrime + a.y) * kPrime + a.z) * kPrime + a.w;
  return w * pow32(kPrime, (unsigned long long)(124 - 4 * t) +
                               (unsigned long long)(n - r1));
}

// One block per chunk of `chunk` rows (one block for zero rows).
__global__ void __launch_bounds__(kGuardThreads) guard_copy_fused(
    const uint4* __restrict__ in, uint4* __restrict__ out,
    uint32_t* __restrict__ partials, int* __restrict__ counter, long long rows,
    long long chunk, uint32_t tag, uint32_t expected, uint32_t* __restrict__ mac_ok) {
  __shared__ uint32_t red[4];
  __shared__ int last;
  const long long c = blockIdx.x;
  const long long r0 = c * chunk;
  const long long r1 = min(rows, r0 + chunk);
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const long long per_warp = (chunk + 3) / 4;
  const long long w0 = min(r1, r0 + warp * per_warp);
  const long long w1 = min(r1, w0 + per_warp);
  uint32_t s = block_sum(quad_partial(in, out, w0, w1, rows, t), red);
  const uint32_t seed = (kInit + tag) * pow32(kPrime, (unsigned long long)rows) * kFoldSum;
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      s += seed;
      mac_ok[0] = s;
      mac_ok[1] = s == expected ? 1u : 0u;
    }
    return;
  }
  if (threadIdx.x == 0) {
    partials[c] = s;
    __threadfence();
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  s = 0u;
  for (long long i = threadIdx.x; i < gridDim.x; i += kGuardThreads) s += __ldcg(partials + i);
  __syncthreads();                      // red is reused
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    s += seed;
    mac_ok[0] = s;
    mac_ok[1] = s == expected ? 1u : 0u;
    *counter = 0;
  }
}

constexpr int kMacMaxThreads = 512;  // mac_update / mac_batch blocks: 4-16 warps
constexpr int kMacMaxWarps = kMacMaxThreads / 32;

// Horner over rows [r0, r1) of this thread's 4 lanes (16 bytes at column
// t, read once: ld.cs), kAhead rows loaded ahead of their steps:
// a_i = Σ_r x_{r,4t+i}·P^(r1-1-r).
__device__ __forceinline__ uint4 quad_horner(const uint4* __restrict__ in, long long r0,
                                             long long r1, int t) {
  uint4 a = make_uint4(0u, 0u, 0u, 0u);
  long long r = r0;
  for (; r + kAhead <= r1; r += kAhead) {
    uint4 x[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) x[i] = __ldcs(in + (r + i) * 32 + t);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) horner4(a, x[i]);
  }
  for (; r < r1; ++r) horner4(a, __ldcs(in + r * 32 + t));
  return a;
}

// The run of rows [w0, w1) that warp `warp` of the block takes from chunk
// c: the chunk split into blockDim.x / 32 runs of equal length.
struct Run {
  long long w0, w1;
};
__device__ __forceinline__ Run warp_run(long long c, long long chunk, long long rows) {
  const long long warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const long long r0 = c * chunk;
  const long long r1 = min(rows, r0 + chunk);
  const long long per_warp = (chunk + warps - 1) / warps;
  const long long w0 = min(r1, r0 + warp * per_warp);
  return {w0, min(r1, w0 + per_warp)};
}

// Per-lane wrapping sum of the warps' uint4 in red (warp w's thread t at
// red[32 w + t]): the value of lane threadIdx.x, for threads 0..127.
__device__ __forceinline__ uint32_t lane_sum(const uint4* red) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(red);
  uint32_t s = 0u;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += words[w * kLanes + threadIdx.x];
  return s;
}

// One block per chunk of `chunk` rows (one block for zero rows); out_l =
// h_l·P^rows + Σ_r x_{r,l}·P^(rows-1-r). counters: the arrival counter,
// then the 128-word accumulator of the chunks' per-lane partials, all 0 on
// entry and on exit.
__global__ void __launch_bounds__(kMacMaxThreads) mac_update_fused(
    const uint32_t* __restrict__ h, const uint4* __restrict__ in,
    uint32_t* __restrict__ counters, long long rows, long long chunk,
    uint32_t* __restrict__ out) {
  __shared__ uint4 red[kMacMaxWarps][32];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const bool lane_thread = threadIdx.x < kLanes;
  const long long nc = gridDim.x;
  const Run run = warp_run(blockIdx.x, chunk, rows);
  uint4 a = quad_horner(in, run.w0, run.w1, t);
  const uint32_t scale = pow32(kPrime, (unsigned long long)(rows - run.w1));
  a.x *= scale;
  a.y *= scale;
  a.z *= scale;
  a.w *= scale;
  red[warp][t] = a;
  __syncthreads();
  const uint32_t s = lane_thread ? lane_sum(&red[0][0]) : 0u;
  const uint32_t seed = lane_thread ? h[threadIdx.x] * pow32(kPrime, (unsigned long long)rows) : 0u;
  if (nc == 1) {
    if (lane_thread) out[threadIdx.x] = seed + s;
    return;
  }
  uint32_t* acc = counters + 1;
  if (lane_thread) atomicAdd(acc + threadIdx.x, s);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(reinterpret_cast<int*>(counters), 1) == (int)nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (lane_thread) out[threadIdx.x] = seed + atomicExch(acc + threadIdx.x, 0u);
  if (threadIdx.x == 0) counters[0] = 0u;
}

// Grid (chunk, frame); frames are `rows` apart. macs[f] = the folded MAC of
// frame f seeded with INIT + tag. partials: gridDim.x words a frame;
// counters: one a frame.
__global__ void __launch_bounds__(kMacMaxThreads) mac_batch_fused(
    const uint4* __restrict__ in, uint32_t* __restrict__ partials,
    int* __restrict__ counters, long long rows, long long chunk, uint32_t tag,
    uint32_t* __restrict__ macs) {
  __shared__ uint32_t red[kMacMaxWarps];
  __shared__ int last;
  const int t = threadIdx.x & 31;
  const long long c = blockIdx.x, nc = gridDim.x, f = blockIdx.y;
  const Run run = warp_run(c, chunk, rows);
  const uint4 a = quad_horner(in + f * rows * 32, run.w0, run.w1, t);
  // fold the 4 lanes (lane 4t+3 has the lowest power) and scale to the end
  const uint32_t w = ((a.x * kPrime + a.y) * kPrime + a.z) * kPrime + a.w;
  uint32_t s = block_sum(
      w * pow32(kPrime, (unsigned long long)(124 - 4 * t) + (unsigned long long)(rows - run.w1)),
      red);
  const uint32_t seed = (kInit + tag) * pow32(kPrime, (unsigned long long)rows) * kFoldSum;
  if (nc == 1) {
    if (threadIdx.x == 0) macs[f] = s + seed;
    return;
  }
  if (threadIdx.x == 0) {
    partials[f * nc + c] = s;
    __threadfence();
    last = atomicAdd(counters + f, 1) == (int)nc - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  s = 0u;
  for (long long i = threadIdx.x; i < nc; i += blockDim.x) s += __ldcg(partials + f * nc + i);
  __syncthreads();                      // red is reused
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    macs[f] = s + seed;
    counters[f] = 0;
  }
}

// One block per (chunk, frame): the folded partial of the chunk.
// frames are `rows` apart; guard_copy passes out != nullptr (one frame).
__global__ void __launch_bounds__(kLanes) folded_chunks(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    uint32_t* __restrict__ partials, long long rows, long long chunk) {
  __shared__ uint32_t red[4];
  const long long frame = blockIdx.y;
  const long long c = blockIdx.x;
  const long long r0 = c * chunk;
  const long long r1 = min(rows, r0 + chunk);
  const uint32_t* src = in + frame * rows * kLanes;
  uint32_t* dst = out == nullptr ? nullptr : out + frame * rows * kLanes;
  const int lane = threadIdx.x;
  const uint32_t part = chunk_partial(src, dst, r0, r1, rows, lane);
  const uint32_t s = block_sum(part * fold_power(lane), red);
  if (threadIdx.x == 0) partials[frame * gridDim.x + c] = s;
}

// One block per frame: Σ chunk partials + the folded seed term h0·P^rows.
__global__ void __launch_bounds__(kLanes) folded_finish(
    const uint32_t* __restrict__ partials, long long n_chunks, long long rows,
    uint32_t tag, uint32_t* __restrict__ macs, uint32_t expected,
    int32_t* __restrict__ ok) {
  __shared__ uint32_t red[4];
  const long long frame = blockIdx.x;
  uint32_t s = 0u;
  for (long long i = threadIdx.x; i < n_chunks; i += kLanes)
    s += partials[frame * n_chunks + i];
  const uint32_t h0 = kInit + tag;
  s += h0 * pow32(kPrime, (unsigned long long)rows) * fold_power(threadIdx.x);
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    macs[frame] = s;
    if (ok != nullptr) ok[frame] = (s == expected) ? 1 : 0;
  }
}

// One block per chunk: the unfolded per-lane partial of the chunk.
__global__ void __launch_bounds__(kLanes) lane_chunks(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ partials,
    long long rows, long long chunk) {
  const long long c = blockIdx.x;
  const long long r0 = c * chunk;
  const long long r1 = min(rows, r0 + chunk);
  partials[c * kLanes + threadIdx.x] =
      chunk_partial(in, nullptr, r0, r1, rows, threadIdx.x);
}

// One block: h'_l = h_l·P^rows + Σ chunk partials_l.
__global__ void __launch_bounds__(kLanes) lane_finish(
    const uint32_t* __restrict__ h, const uint32_t* __restrict__ partials,
    long long n_chunks, long long rows, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  uint32_t s = h[lane] * pow32(kPrime, (unsigned long long)rows);
  for (long long i = 0; i < n_chunks; ++i) s += partials[i * kLanes + lane];
  out[lane] = s;
}

__global__ void __launch_bounds__(kLanes) init_state(uint32_t tag,
                                                      uint32_t* __restrict__ out) {
  out[threadIdx.x] = kInit + tag;
}

__global__ void __launch_bounds__(kLanes) fold_state(
    const uint32_t* __restrict__ h, uint32_t* __restrict__ mac) {
  __shared__ uint32_t red[4];
  const uint32_t s = block_sum(h[threadIdx.x] * fold_power(threadIdx.x), red);
  if (threadIdx.x == 0) mac[0] = s;
}

long long n_chunks(long long rows, long long chunk) {
  return (rows + chunk - 1) / chunk;
}

bool mac_launch_ok(long long chunk, int threads) {
  return chunk >= 1 && threads >= kLanes && threads <= kMacMaxThreads && threads % 32 == 0;
}

}  // namespace

extern "C" {

// payload (rows, 128) → copy (rows, 128), mac_ok (2,) = {mac, ok}, in one
// launch; payload and copy 16-byte aligned. partials: max(1, ceil(rows /
// chunk)) words of scratch; counter: one int32, 0 on entry and on exit.
int mpk_guard_copy(const void* payload, void* copy, void* partials, void* counter,
                   void* mac_ok, long long rows, long long chunk, unsigned tag,
                   unsigned expected, void* stream) {
  const long long nc = rows > 0 ? n_chunks(rows, chunk) : 1;
  guard_copy_fused<<<(unsigned)nc, kGuardThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(payload), static_cast<uint4*>(copy),
      static_cast<uint32_t*>(partials), static_cast<int*>(counter), rows, chunk, tag,
      expected, static_cast<uint32_t*>(mac_ok));
  return (int)cudaGetLastError();
}

// The earlier two-launch guard_copy (folded_chunks, then folded_finish):
// payload (rows, 128) → copy, mac (1,), ok (1,); partials: max(1, ceil(rows
// / chunk)) words. Not on any path of the port: chip_smoke.py's yardstick.
int mpk_guard_copy_two_pass(const void* payload, void* copy, void* partials, void* mac,
                            void* ok, long long rows, long long chunk, unsigned tag,
                            unsigned expected, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nc = n_chunks(rows, chunk);
  if (nc > 0)
    folded_chunks<<<dim3((unsigned)nc, 1), kLanes, 0, s>>>(
        static_cast<const uint32_t*>(payload), static_cast<uint32_t*>(copy),
        static_cast<uint32_t*>(partials), rows, chunk);
  folded_finish<<<1, kLanes, 0, s>>>(
      static_cast<const uint32_t*>(partials), nc, rows, tag,
      static_cast<uint32_t*>(mac), expected, static_cast<int32_t*>(ok));
  return (int)cudaGetLastError();
}

// stack (frames, rows, 128) → macs (frames,), one launch; the stack 16-byte
// aligned. partials: frames * max(1, ceil(rows / chunk)) words of scratch;
// counters: `frames` int32, 0 on entry and on exit. threads: 128..512, a
// multiple of 32.
int mpk_mac_batch(const void* stack, void* partials, void* counters, void* macs,
                  long long frames, long long rows, long long chunk, int threads,
                  unsigned tag, void* stream) {
  if (!mac_launch_ok(chunk, threads) || frames < 1 || frames > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nc = rows > 0 ? n_chunks(rows, chunk) : 1;
  mac_batch_fused<<<dim3((unsigned)nc, (unsigned)frames), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(stack), static_cast<uint32_t*>(partials),
      static_cast<int*>(counters), rows, chunk, tag, static_cast<uint32_t*>(macs));
  return (int)cudaGetLastError();
}

// state h (128,), block (rows, 128) → out (128,), one launch; the block
// 16-byte aligned. counters: 1 + 128 words, 0 on entry and on exit.
int mpk_mac_update(const void* h, const void* block, void* counters, void* out,
                   long long rows, long long chunk, int threads, void* stream) {
  if (!mac_launch_ok(chunk, threads)) return (int)cudaErrorInvalidValue;
  const long long nc = rows > 0 ? n_chunks(rows, chunk) : 1;
  mac_update_fused<<<(unsigned)nc, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(h), static_cast<const uint4*>(block),
      static_cast<uint32_t*>(counters), rows, chunk, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// The earlier two-launch mac_batch (folded_chunks, then folded_finish):
// partials: max(1, frames * ceil(rows / chunk)) words. The legacy copy
// plane's mac_batch and chip_smoke.py's yardstick.
int mpk_mac_batch_two_pass(const void* stack, void* partials, void* macs,
                           long long frames, long long rows, long long chunk,
                           unsigned tag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nc = n_chunks(rows, chunk);
  if (nc > 0)
    folded_chunks<<<dim3((unsigned)nc, (unsigned)frames), kLanes, 0, s>>>(
        static_cast<const uint32_t*>(stack), nullptr,
        static_cast<uint32_t*>(partials), rows, chunk);
  folded_finish<<<(unsigned)frames, kLanes, 0, s>>>(
      static_cast<const uint32_t*>(partials), nc, rows, tag,
      static_cast<uint32_t*>(macs), 0u, nullptr);
  return (int)cudaGetLastError();
}

// The earlier two-launch mac_update (lane_chunks, then lane_finish):
// partials: max(1, ceil(rows / chunk)) * 128 words. The legacy copy
// plane's mac_update and chip_smoke.py's yardstick.
int mpk_mac_update_two_pass(const void* h, const void* block, void* partials, void* out,
                            long long rows, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nc = n_chunks(rows, chunk);
  if (nc > 0)
    lane_chunks<<<(unsigned)nc, kLanes, 0, s>>>(
        static_cast<const uint32_t*>(block), static_cast<uint32_t*>(partials),
        rows, chunk);
  lane_finish<<<1, kLanes, 0, s>>>(
      static_cast<const uint32_t*>(h), static_cast<const uint32_t*>(partials),
      nc, rows, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// → out (128,) = INIT + tag in every lane.
int mpk_mac_init(void* out, unsigned tag, void* stream) {
  init_state<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// state h (128,) → mac (1,).
int mpk_mac_finalize(const void* h, void* mac, void* stream) {
  fold_state<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(h), static_cast<uint32_t*>(mac));
  return (int)cudaGetLastError();
}

}  // extern "C"
