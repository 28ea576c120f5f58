// Kernel KC: the ids of the top-A masked nodes of each sweep, ranked by term
// descending then id ascending, NONE (-1) padded, for 1 <= A <= 16.
//
// Replaces: consensus_tpu/engines/raft_sparse.py _top_active, a two-key
// lax.sort of all N (key, id) pairs, run twice a round (the candidate set of
// P2 and the tracked-leader set). The keys (term desc, id asc) are unique,
// so any exact selection of the A least keys returns the same ids.
//
// Bound: bytes. It must read the mask (1 B) and term (4 B) of every node,
// 4 MB at the flagship shape (B = 8, N = 100 000), about 1.2 us at 3.35 TB/s;
// the selection itself is a few operations a node.
// Design: two launches. Phase 1 spreads each sweep over G blocks; a thread
// keeps a sorted list of its 16 least keys in registers (a branch-free
// min/max insertion, fully unrolled), then the block extracts its A least
// keys by A rounds of a block-wide minimum. Phase 2, one block per sweep,
// does the same over the G * A partial keys. A key is
// (0x7FFFFFFF - term) << 32 | id as a uint64; unmasked nodes carry ~0.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAXA = 16;
constexpr int THREADS = 256;
constexpr unsigned long long KEY_NONE = ~0ull;

__device__ __forceinline__ void insert(unsigned long long (&top)[MAXA],
                                       unsigned long long key) {
#pragma unroll
  for (int q = 0; q < MAXA; ++q) {
    const unsigned long long lo = key < top[q] ? key : top[q];
    key = key < top[q] ? top[q] : key;
    top[q] = lo;
  }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// A rounds of a block-wide minimum over the threads' list heads; the thread
// owning the minimum pops it. Returns the A least keys to thread 0 via sink.
__device__ void extract(unsigned long long (&top)[MAXA], int A,
                        unsigned long long* sink) {
  __shared__ unsigned long long warp_mins[THREADS / 32];
  __shared__ unsigned long long winner;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < A; ++t) {
    const unsigned long long m = warp_min(top[0]);
    if (lane == 0) warp_mins[warp] = m;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v =
          lane < THREADS / 32 ? warp_mins[lane] : KEY_NONE;
      v = warp_min(v);
      if (lane == 0) winner = v;
    }
    __syncthreads();
    const unsigned long long w = winner;
    if (w != KEY_NONE && top[0] == w) {
#pragma unroll
      for (int q = 0; q < MAXA - 1; ++q) top[q] = top[q + 1];
      top[MAXA - 1] = KEY_NONE;
    }
    if (threadIdx.x == 0) sink[t] = w;
    __syncthreads();
  }
}

// Grid (G, B): block g of sweep b takes nodes [g * chunk, (g + 1) * chunk).
__global__ void __launch_bounds__(THREADS)
top_partial_kernel(const bool* __restrict__ mask,
                   const int32_t* __restrict__ term,
                   unsigned long long* __restrict__ partial, int N, int A) {
  const int b = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int chunk = (N + G - 1) / G;
  const int lo = g * chunk;
  const int hi = min(N, lo + chunk);
  unsigned long long top[MAXA];
#pragma unroll
  for (int q = 0; q < MAXA; ++q) top[q] = KEY_NONE;
  const bool* m = mask + static_cast<long long>(b) * N;
  const int32_t* tm = term + static_cast<long long>(b) * N;
  for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
    if (m[i]) {
      const uint32_t desc = static_cast<uint32_t>(0x7FFFFFFFll - tm[i]);
      insert(top, (static_cast<unsigned long long>(desc) << 32) |
                      static_cast<uint32_t>(i));
    }
  }
  extract(top, A, partial + (static_cast<long long>(b) * G + g) * A);
}

// Grid (B): merges the sweep's G * A partial keys into its A ids.
__global__ void __launch_bounds__(THREADS)
top_merge_kernel(const unsigned long long* __restrict__ partial,
                 int32_t* __restrict__ out, int G, int A) {
  __shared__ unsigned long long best[MAXA];
  const int b = blockIdx.x;
  unsigned long long top[MAXA];
#pragma unroll
  for (int q = 0; q < MAXA; ++q) top[q] = KEY_NONE;
  const unsigned long long* p = partial + static_cast<long long>(b) * G * A;
  for (int i = threadIdx.x; i < G * A; i += THREADS) insert(top, p[i]);
  extract(top, A, best);
  __syncthreads();
  if (threadIdx.x < A) {
    const unsigned long long k = best[threadIdx.x];
    out[b * A + threadIdx.x] =
        k == KEY_NONE ? -1 : static_cast<int32_t>(k & 0xFFFFFFFFull);
  }
}

}  // namespace

extern "C" int ctt_top_active(const bool* mask, const int32_t* term,
                              unsigned long long* partial, int32_t* out,
                              int B, int N, int A, int G, cudaStream_t st) {
  if (A < 1 || A > MAXA || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  top_partial_kernel<<<dim3(G, B), THREADS, 0, st>>>(mask, term, partial, N,
                                                       A);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  top_merge_kernel<<<B, THREADS, 0, st>>>(partial, out, G, A);
  return static_cast<int>(cudaGetLastError());
}
