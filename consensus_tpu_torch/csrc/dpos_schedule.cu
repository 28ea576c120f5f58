// Kernel KW: the SPEC §7 DPoS epoch schedule of each lane: stakes, votes,
// the stake tally of every (epoch, candidate) and each epoch's top K
// candidates, computed once at init.
//
// Replaces: consensus_tpu/engines/dpos.py dpos_schedule (K20, lines 53-70),
// which dpos_make_carry (line 201) runs once from the seed. Validator v's
// stake is draw(STAKE, 0, 0, v) mod 1000 + 1; in epoch e it votes for
// candidate draw(VOTE, e, 0, v) mod C; tally[e, c] is the int32 sum of the
// stakes voting for c; producers[e] are the first K of a stable ascending
// argsort of the negated tallies (most stake first, ties to the lower id).
//
// Bound: operations, counting the draws the function needs: one Threefry
// draw (about 120 integer operations) for each validator's stake, and one
// draw and one add for each (epoch, validator)'s vote; the sort is C log2 C
// comparisons an epoch. At dpos-100k (B = 1, E = 8, V = 100 000, C = 1024)
// that is 9 draws a validator, about 1.1e8 operations, 3.2 us at 33.5e12 a
// second; the outputs are 33 KB.
// Design: launch 1 (after the tallies are zeroed), a thread per (lane,
// validator) draws its stake once and, in every epoch, adds it to its
// vote's tally with an integer atomicAdd: modular int32 addition gives the
// same sum in any order. Launch 2, a thread per (lane, epoch, candidate)
// counts the candidates ranked before it, reading the epoch's tallies 256
// at a time from shared memory, and writes its id at that rank when the
// rank is below K; a block stops when every thread's rank has reached K.
// Its grid puts (candidate chunk, lane, epoch) into x, so any number of
// lanes launches. The negation wraps as the reference's int32 one does.
#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int32_t neg_i32(int32_t x) {
  return static_cast<int32_t>(0u - static_cast<uint32_t>(x));
}

// Launch 1. A thread per (lane, validator), flattened.
__global__ void __launch_bounds__(THREADS)
dpos_tally_kernel(const uint32_t* __restrict__ seeds,
                  int32_t* __restrict__ tallies, int E, int V, int C,
                  long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long b = i / V;
  const uint32_t v = static_cast<uint32_t>(i - b * V);
  const uint32_t sd = seeds[b];
  const int32_t stake = static_cast<int32_t>(
      ctt::random_u32(sd, ctt::STREAM_STAKE, 0u, 0u, v) % 1000u + 1u);
  int32_t* t = tallies + b * E * C;
  for (int e = 0; e < E; ++e) {
    const uint32_t vote =
        ctt::random_u32(sd, ctt::STREAM_VOTE, static_cast<uint32_t>(e), 0u,
                        v) %
        static_cast<uint32_t>(C);
    atomicAdd(t + static_cast<long long>(e) * C + vote, stake);
  }
}

// Launch 2. A block per (candidate chunk, lane x epoch), flattened.
__global__ void __launch_bounds__(THREADS)
dpos_rank_kernel(const int32_t* __restrict__ tallies,
                 int32_t* __restrict__ producers, int C, int K, int chunks) {
  __shared__ int32_t tile[THREADS];
  const long long be = blockIdx.x / chunks;
  const int c = static_cast<int>(blockIdx.x - be * chunks) * THREADS +
                static_cast<int>(threadIdx.x);
  const int32_t* t = tallies + be * C;
  const int32_t key = c < C ? neg_i32(t[c]) : 0;
  int rank = 0;
  for (int j0 = 0; j0 < C; j0 += THREADS) {
    if (__syncthreads_and(c >= C || rank >= K)) break;
    if (j0 + static_cast<int>(threadIdx.x) < C)
      tile[threadIdx.x] = neg_i32(t[j0 + threadIdx.x]);
    __syncthreads();
    const int n = min(THREADS, C - j0);
    for (int k = 0; k < n; ++k) {
      const int32_t kj = tile[k];
      rank += (kj < key) || (kj == key && j0 + k < c);
    }
  }
  if (c < C && rank < K) producers[be * K + rank] = c;
}

}  // namespace

extern "C" int ctt_dpos_schedule(const uint32_t* seeds, int32_t* producers,
                                 int32_t* tallies, int B, int E, int V, int C,
                                 int K, cudaStream_t st) {
  if (B == 0 || E == 0) return 0;
  const long long be = static_cast<long long>(B) * E;
  int err = static_cast<int>(cudaMemsetAsync(
      tallies, 0, static_cast<size_t>(be) * C * sizeof(int32_t), st));
  if (err != 0) return err;
  const long long total = static_cast<long long>(B) * V;
  if (total > 0) {
    dpos_tally_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                        THREADS, 0, st>>>(seeds, tallies, E, V, C, total);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int chunks = (C + THREADS - 1) / THREADS;
  dpos_rank_kernel<<<static_cast<unsigned>(be * chunks), THREADS, 0, st>>>(
      tallies, producers, C, K, chunks);
  return static_cast<int>(cudaGetLastError());
}
