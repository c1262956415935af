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
// chunk of rows, runs Horner over it per lane (128 threads, one lane each,
// one coalesced 512-byte row per step) and scales its partial by
// P^(rows after the chunk) with square-and-multiply. Partials combine by
// wrapping uint32 adds, which are associative: a second small kernel sums
// them in a fixed order and adds the seed term h0·P^n once, so the result
// is bit-exact. For the folded MACs each block folds its lanes before
// writing (the fold is linear too), so the second pass sums one word per
// chunk. guard_copy writes each row as it reads it. A zero-row payload
// launches only the second kernel, which returns the fold of h0 (or h
// itself for mac_update); rows are never padded, since padding would change
// the MAC.
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

// Wrapping sum of one uint32 per thread over a 128-thread block; the
// result is valid in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return red[0] + red[1] + red[2] + red[3];
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

}  // namespace

extern "C" {

// payload (rows, 128) → copy (rows, 128), mac (1,), ok (1,).
// partials: max(1, ceil(rows / chunk)) words of scratch.
int mpk_guard_copy(const void* payload, void* copy, void* partials, void* mac,
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

// stack (frames, rows, 128) → macs (frames,).
// partials: max(1, frames * ceil(rows / chunk)) words of scratch.
int mpk_mac_batch(const void* stack, void* partials, void* macs,
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

// state h (128,), block (rows, 128) → out (128,).
// partials: max(1, ceil(rows / chunk)) * 128 words of scratch.
int mpk_mac_update(const void* h, const void* block, void* partials, void* out,
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
