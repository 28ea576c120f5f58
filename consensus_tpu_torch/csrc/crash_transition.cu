// Kernel KAH: the SPEC §6c crash transition of round r on every node of each
// lane, with the round's crash telemetry.
//
// Replaces: consensus_tpu/ops/adversary.py crash_transition (K13, lines
// 101-130) and crash_counts (lines 143-152), as every engine but HotStuff
// calls them at the start of a round with crash_prob > 0.
//
// A down node recovers where its Threefry draw (seed ^ CRASH, r, 1, i) is
// below recover_cut; a node up after the recoveries crashes where its draw
// (seed ^ CRASH, r, 0, i) is below crash_cut. With max_crashed > 0 a
// would-be crasher crashes only where the count still down plus its rank
// among the lane's would-be crashers in ascending id order (inclusive) stays
// within max_crashed: the JAX package's cumsum. Outputs: the new down mask
// (bool) and the flag word of crash.cuh, fresh; with telemetry the lane's
// (crashes, recoveries, nodes down) are added into columns col..col+2 of
// the totals t[B, K] and of window `window` of the ring w[B, n_windows, K].
//
// Bound: N bytes in, 2N bytes out and up to two Threefry draws a node.
// Design: without a cap, one launch: a thread per node and a block
// reduction of the three counts with one atomic a block and count. With a
// cap, two launches over tiles of kScanThreads nodes, a block a (tile,
// lane): the first counts each tile's nodes still down and would-be
// crashers into scratch; the second sums the lane's still-down count and
// the would-be crashers of the tiles before its own, ranks its tile's
// would-be crashers by a block scan (warp ballots, then the warps' sums)
// on top of them, and writes the outputs. Both draw a node's words; the
// second draws them again rather than keep them. (One block a lane
// walking the tiles in turn took 218 us a call at B = 8, N = 100 000 on
// the H100, 97% of a capped dpos-100k replay.)
// KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh): each launch reads its lane's crash and recover cutoffs from
// the lane's row of the table in place of the arguments.
#include <cuda_runtime.h>

#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool recovers(uint32_t seed, uint32_t r, int i,
                                         uint32_t recover_cut) {
  return ctt::random_u32(seed, ctt::STREAM_CRASH, r, 1u,
                         static_cast<uint32_t>(i)) < recover_cut;
}

__device__ __forceinline__ bool wants(uint32_t seed, uint32_t r, int i,
                                      uint32_t crash_cut) {
  return ctt::random_u32(seed, ctt::STREAM_CRASH, r, 0u,
                         static_cast<uint32_t>(i)) < crash_cut;
}

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024);
// every thread gets it. `red` holds 32 ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) s += red[k];
  return s;
}

__device__ __forceinline__ void add_counts(int* t, int* w, long long b,
                                           int K, int col, int window,
                                           int n_windows, const int c[3]) {
  if (t == nullptr) return;
  for (int k = 0; k < 3; ++k) {
    if (c[k] == 0) continue;
    atomicAdd(t + b * K + col + k, c[k]);
    if (w != nullptr)
      atomicAdd(w + (b * n_windows + window) * K + col + k, c[k]);
  }
}

// Grid (ceil(N / kThreads), B): no cap.
template <bool KNOBS>
__global__ void crash_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                             const bool* __restrict__ down,
                             bool* __restrict__ down_out,
                             unsigned char* __restrict__ flags, int N,
                             uint32_t crash_cut, uint32_t recover_cut,
                             int* t, int* w, int K, int col, int window,
                             int n_windows,
                             const long long* __restrict__ knobs) {
  __shared__ int red[32];
  const long long b = blockIdx.y;
  if (KNOBS) {
    crash_cut = ctt::knob(knobs, b, ctt::KNOB_CRASH);
    recover_cut = ctt::knob(knobs, b, ctt::KNOB_RECOVER);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int c[3] = {0, 0, 0};
  if (i < N) {
    const uint32_t sd = seed[b];
    const long long at = b * N + i;
    const bool was = down[at];
    const bool rec = was && recovers(sd, r, i, recover_cut);
    const bool still = was && !rec;
    const bool crashed = !still && wants(sd, r, i, crash_cut);
    const bool now = still || crashed;
    down_out[at] = now;
    flags[at] = (now ? ctt::CRASH_DOWN : 0) | (rec ? ctt::CRASH_REC : 0) |
                (crashed ? ctt::CRASH_NEW : 0);
    c[0] = crashed, c[1] = rec, c[2] = now;
  }
  if (t == nullptr) return;
  for (int k = 0; k < 3; ++k) c[k] = block_sum(c[k], red);
  if (threadIdx.x == 0) add_counts(t, w, b, K, col, window, n_windows, c);
}

// Node i of lane b's transition before the cap: recovered, still down,
// would crash.
struct Step {
  bool rec, still, want;
};

__device__ __forceinline__ Step step(uint32_t sd, uint32_t r, bool was,
                                     int i, uint32_t crash_cut,
                                     uint32_t recover_cut) {
  Step s;
  s.rec = was && recovers(sd, r, i, recover_cut);
  s.still = was && !s.rec;
  s.want = !s.still && wants(sd, r, i, crash_cut);
  return s;
}

// Cap, launch 1. Grid (tiles, B), kScanThreads threads: each tile's count
// still down and its would-be crashers, into scratch [B, 2, tiles].
template <bool KNOBS>
__global__ void crash_tile_count_kernel(const uint32_t* __restrict__ seed,
                                        uint32_t r,
                                        const bool* __restrict__ down,
                                        int* __restrict__ tile_counts, int N,
                                        uint32_t crash_cut,
                                        uint32_t recover_cut,
                                        const long long* __restrict__ knobs) {
  __shared__ int red[32];
  const long long b = blockIdx.y;
  if (KNOBS) {
    crash_cut = ctt::knob(knobs, b, ctt::KNOB_CRASH);
    recover_cut = ctt::knob(knobs, b, ctt::KNOB_RECOVER);
  }
  const int tiles = gridDim.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int still = 0, want = 0;
  if (i < N) {
    const Step s =
        step(seed[b], r, down[b * N + i], i, crash_cut, recover_cut);
    still = s.still, want = s.want;
  }
  still = block_sum(still, red);
  want = block_sum(want, red);
  if (threadIdx.x == 0) {
    tile_counts[(b * 2) * tiles + blockIdx.x] = still;
    tile_counts[(b * 2 + 1) * tiles + blockIdx.x] = want;
  }
}

// Cap, launch 2. Grid (tiles, B), kScanThreads threads: the tile's would-be
// crashers ranked in ascending id order on top of the tiles before it.
template <bool KNOBS>
__global__ void crash_cap_kernel(const uint32_t* __restrict__ seed,
                                 uint32_t r, const bool* __restrict__ down,
                                 const int* __restrict__ tile_counts,
                                 bool* __restrict__ down_out,
                                 unsigned char* __restrict__ flags, int N,
                                 uint32_t crash_cut, uint32_t recover_cut,
                                 long long max_crashed, int* t, int* w, int K,
                                 int col, int window, int n_windows,
                                 const long long* __restrict__ knobs) {
  __shared__ int red[32];
  __shared__ int warp_sums[32];
  const long long b = blockIdx.y;
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // The lane's count still down, and the would-be crashers before the tile.
  int still = 0, before = 0;
  for (int k = threadIdx.x; k < tiles; k += blockDim.x) {
    still += tile_counts[(b * 2) * tiles + k];
    before += k < tile ? tile_counts[(b * 2 + 1) * tiles + k] : 0;
  }
  const long long base = block_sum(still, red);
  const long long earlier = block_sum(before, red);

  const int i = tile * blockDim.x + threadIdx.x;
  const bool was = i < N && down[b * N + i];
  // The row is read here, after the sums, so that the cutoffs take no
  // register across them (at 34 registers a 1024-thread block fills half
  // an SM, where the flat instance's 32 fit two).
  if (KNOBS) {
    crash_cut = ctt::knob(knobs, b, ctt::KNOB_CRASH);
    recover_cut = ctt::knob(knobs, b, ctt::KNOB_RECOVER);
  }
  Step s = {false, false, false};
  if (i < N) s = step(seed[b], r, was, i, crash_cut, recover_cut);
  const unsigned ballot = __ballot_sync(0xffffffffu, s.want);
  const int in_warp = __popc(ballot & ((2u << lane) - 1u));  // inclusive
  if (lane == 31) warp_sums[warp] = in_warp;
  __syncthreads();
  int prefix = 0;
  for (int k = 0; k < warp && k < nwarps; ++k) prefix += warp_sums[k];
  int c[3] = {0, 0, 0};
  if (i < N) {
    const bool crashed = s.want && base + earlier + prefix + in_warp <=
                                       max_crashed;
    const bool now = s.still || crashed;
    down_out[b * N + i] = now;
    flags[b * N + i] = (now ? ctt::CRASH_DOWN : 0) |
                       (s.rec ? ctt::CRASH_REC : 0) |
                       (crashed ? ctt::CRASH_NEW : 0);
    c[0] = crashed, c[1] = s.rec, c[2] = now;
  }
  if (t == nullptr) return;
  for (int k = 0; k < 3; ++k) c[k] = block_sum(c[k], red);
  if (threadIdx.x == 0) add_counts(t, w, b, K, col, window, n_windows, c);
}

}  // namespace

// tile_counts is scratch, [B, 2, ceil(N / 1024)] int32, written by the
// first launch of the capped path (unused without a cap). knobs is a knob
// batch's [B, 12] table (knobs.cuh; null but in a knob batch).
extern "C" int ctt_crash_transition(const uint32_t* seed, uint32_t r,
                                    const bool* down, bool* down_out,
                                    unsigned char* flags, uint32_t crash_cut,
                                    uint32_t recover_cut, int max_crashed,
                                    int* t, int* w, int* tile_counts, int B,
                                    int N, int K, int col, int window,
                                    int n_windows, const long long* knobs,
                                    cudaStream_t st) {
  if (B == 0 || N == 0) return 0;
  const bool kn = knobs != nullptr;
  if (max_crashed > 0) {
    const dim3 grid((N + kScanThreads - 1) / kScanThreads, B);
    const auto count =
        kn ? crash_tile_count_kernel<true> : crash_tile_count_kernel<false>;
    count<<<grid, kScanThreads, 0, st>>>(seed, r, down, tile_counts, N,
                                         crash_cut, recover_cut, knobs);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const auto cap = kn ? crash_cap_kernel<true> : crash_cap_kernel<false>;
    cap<<<grid, kScanThreads, 0, st>>>(
        seed, r, down, tile_counts, down_out, flags, N, crash_cut,
        recover_cut, max_crashed, t, w, K, col, window, n_windows, knobs);
  } else {
    const dim3 grid((N + kThreads - 1) / kThreads, B);
    const auto one = kn ? crash_kernel<true> : crash_kernel<false>;
    one<<<grid, kThreads, 0, st>>>(seed, r, down, down_out, flags, N,
                                   crash_cut, recover_cut, t, w, K, col,
                                   window, n_windows, knobs);
  }
  return static_cast<int>(cudaGetLastError());
}
