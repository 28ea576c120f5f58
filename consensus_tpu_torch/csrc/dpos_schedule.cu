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
// Design: two launches, no memset and no global atomic. The draws are most
// of the work, so they are spread over every SM, each drawn once:
//  1. G blocks a lane (G = the SMs over the lanes, from the wrapper) each
//     take a chunk of the validators: a thread draws a validator's stake
//     and its vote of every epoch and adds the stake into the block's
//     [E, C] u32 histogram in shared memory (a shared atomic; epochs in
//     groups where E C words do not fit), then the block stores the
//     histogram as its lane's partial g (plain stores).
//  2. A thread block cluster (up to 8 blocks, SM 9.0) a (lane, epoch):
//     each block takes a slice of the candidates, sums their partials
//     (threads a candidate each summing every R-th partial in a register,
//     then a shared atomic), writes those tallies and packs each as a u64
//     key: high word the negated tally as u32 (wrapping, as the
//     reference's int32 negation) xor 0x80000000, which keeps the int32
//     order, low word the candidate id. So the ascending order of the keys
//     is exactly the stable ascending argsort of the negated tallies, ties
//     to the lower id, and the keys are distinct. Each block counts, for
//     each key, the slice's keys below it, and puts the keys that count
//     below kk = min(K, slice) into the first block's union (distributed
//     shared memory); after cluster.sync() the first block counts, for
//     each key of the union, the union's keys below it. That count is the
//     key's rank among all C where it is below K: every key below a key
//     of the first K is in the union, and a key outside the first K
//     counts K or more, since a slice cut short put K keys below it into
//     the union. Each of the first K ids is written at its rank. No sort:
//     the counts are a few thousand comparisons a block.
// The second launch is the grid-wide barrier between the draws and the
// sums: one launch would need a zeroed last-block-done counter (a memset, a
// device operation too) or clusters a (lane, epoch), which hold 16 SMs at
// most and would draw each stake once an epoch. Modular u32 addition gives
// the same tallies in any order of the atomics, partials and blocks, and
// the keys are distinct, so the result does not depend on order.
// Large C: where C's keys do not fit in one block's shared memory (C > 16
// 384, the wrapper passes no partials) the RANKS instance runs instead:
// the tallies are zeroed, a thread per (lane, validator) adds its stake
// into its vote's tally of every epoch with a global atomicAdd, and a
// thread per (lane, epoch, candidate) counts the candidates ranked before
// it, writing its id at that rank when the rank is below K (a memset and
// two launches).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rng.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int RANK_THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int CLUSTER_SLICE = 128;  // candidates a block sums at least
constexpr int KEYS_MAX_C = 16384;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100
using u64 = unsigned long long;

__device__ __forceinline__ int32_t neg_i32(int32_t x) {
  return static_cast<int32_t>(0u - static_cast<uint32_t>(x));
}

__device__ __forceinline__ int32_t stake_of(uint32_t sd, uint32_t v) {
  return static_cast<int32_t>(
      ctt::random_u32(sd, ctt::STREAM_STAKE, 0u, 0u, v) % 1000u + 1u);
}

__device__ __forceinline__ uint32_t vote_of(uint32_t sd, uint32_t e,
                                            uint32_t v, int C) {
  return ctt::random_u32(sd, ctt::STREAM_VOTE, e, 0u, v) %
         static_cast<uint32_t>(C);
}

// Launch 1. G blocks a lane, flattened into x: block g of lane b takes
// validators [g ch, (g + 1) ch) and epochs [e0, e0 + eg) at a time, and
// stores each epoch's histogram as partials[b, g, e].
__global__ void __launch_bounds__(THREADS)
dpos_partial_kernel(const uint32_t* __restrict__ seeds,
                    unsigned* __restrict__ partials, int E, int V, int C,
                    int G, int ch, int eg) {
  extern __shared__ unsigned hist[];  // [eg, C]
  const long long b = blockIdx.x / G;
  const int g = static_cast<int>(blockIdx.x - b * G);
  const int t = threadIdx.x, T = blockDim.x;
  const uint32_t sd = seeds[b];
  const int v1 = min(V, (g + 1) * ch);
  for (int e0 = 0; e0 < E; e0 += eg) {
    const int n = min(eg, E - e0);
    for (int i = t; i < n * C; i += T) hist[i] = 0u;
    __syncthreads();
    for (int v = g * ch + t; v < v1; v += T) {
      const uint32_t u = static_cast<uint32_t>(v);
      const unsigned stake = static_cast<unsigned>(stake_of(sd, u));
      for (int k = 0; k < n; ++k)
        atomicAdd(&hist[k * C + vote_of(sd, static_cast<uint32_t>(e0 + k),
                                         u, C)],
                  stake);
    }
    __syncthreads();
    unsigned* out = partials + ((b * G + g) * E + e0) * C;
    for (int i = t; i < n * C; i += T) out[i] = hist[i];
    __syncthreads();
  }
}

// The keys of `keys` ([n]) below `x`, counted by the block's threads in
// turns of `parts` a key: thread (i, part) counts part's share into
// count[i] with a shared atomic.
__device__ __forceinline__ void count_below(const u64* keys, int n,
                                            int parts, unsigned* count) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int f = t; f < n * parts; f += T) {
    const int i = f / parts, part = f - i * parts;
    const u64 x = keys[i];
    unsigned c = 0u;
    for (int k = part; k < n; k += parts) c += keys[k] < x;
    atomicAdd(&count[i], c);
  }
}

// Launch 2. A cluster a (lane, epoch), flattened into x. Block r of the
// cluster takes the candidates [r slice, (r + 1) slice): their sums over
// the lane's G partials, their tallies, their packed keys, and each key's
// rank within the slice; the keys ranked below kk (= min(K, slice)) go to
// the first block's union. Shared memory: [slice] u64 keys, [cs kk] u64
// union (read in the first block), [slice] u32 sums (then ranks), [cs kk]
// u32 union ranks.
__global__ void __launch_bounds__(THREADS, 1)
dpos_top_kernel(const unsigned* __restrict__ partials,
                int32_t* __restrict__ producers,
                int32_t* __restrict__ tallies, int E, int C, int K, int G,
                int kk) {
  extern __shared__ u64 keys[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long pair = blockIdx.x / cs;  // b * E + e
  const long long b = pair / E;
  const int e = static_cast<int>(pair - b * E);
  const int t = threadIdx.x, T = blockDim.x;
  const int slice = (C + cs - 1) / cs;
  const int c0 = rank * slice;
  const int width = max(0, min(slice, C - c0));
  const int n_union = cs * kk;
  u64* pool = keys + slice;
  unsigned* sum = reinterpret_cast<unsigned*>(pool + n_union);
  unsigned* pool_rank = sum + slice;
  for (int i = t; i < width; i += T) sum[i] = 0u;
  for (int i = t; i < n_union; i += T) {
    pool[i] = ~0ull;  // all-ones: no key, above every key
    pool_rank[i] = 0u;
  }
  __syncthreads();
  // R threads a candidate, each summing every R-th partial in a register.
  const unsigned* part = partials + (b * G * E + e) * C + c0;
  const int R = width > 0 ? max(1, T / width) : 1;
  for (int i = t; i < width * R; i += T) {
    const int c = i % width;
    unsigned acc = 0u;
#pragma unroll 8
    for (int g = i / width; g < G; g += R)
      acc += part[static_cast<long long>(g) * E * C + c];
    atomicAdd(&sum[c], acc);
  }
  __syncthreads();
  for (int i = t; i < width; i += T) {
    const unsigned s = sum[i];
    tallies[pair * C + c0 + i] = static_cast<int32_t>(s);
    const uint32_t hi =
        static_cast<uint32_t>(neg_i32(static_cast<int32_t>(s))) ^ 0x80000000u;
    keys[i] = (static_cast<u64>(hi) << 32) | static_cast<uint32_t>(c0 + i);
    sum[i] = 0u;
  }
  cluster.sync();  // the first block's union is cleared before any lands
  count_below(keys, width, max(1, T / max(width, 1)), sum);
  __syncthreads();
  // The keys ranked below kk in the slice hold every key of the first K.
  u64* pool0 = cluster.map_shared_rank(pool, 0);
  for (int i = t; i < width; i += T)
    if (sum[i] < static_cast<unsigned>(kk)) pool0[rank * kk + sum[i]] = keys[i];
  cluster.sync();
  if (rank != 0) return;
  // A key's count of union keys below it: exact below K (every key below
  // a key of the first K is in the union), K or more for any other key,
  // since a slice that lost keys to the cut holds kk = K of them in the
  // union, all below it.
  count_below(pool, n_union, max(1, T / n_union), pool_rank);
  __syncthreads();
  for (int i = t; i < n_union; i += T)
    if (pool[i] != ~0ull && pool_rank[i] < static_cast<unsigned>(K))
      producers[pair * K + pool_rank[i]] =
          static_cast<int32_t>(pool[i] & 0xFFFFFFFFull);
}

// The RANKS instance, launch 1. A thread per (lane, validator), flattened.
__global__ void __launch_bounds__(RANK_THREADS)
dpos_tally_kernel(const uint32_t* __restrict__ seeds,
                  int32_t* __restrict__ tallies, int E, int V, int C,
                  long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * RANK_THREADS + threadIdx.x;
  if (i >= total) return;
  const long long b = i / V;
  const uint32_t v = static_cast<uint32_t>(i - b * V);
  const uint32_t sd = seeds[b];
  const int32_t stake = stake_of(sd, v);
  int32_t* t = tallies + b * E * C;
  for (int e = 0; e < E; ++e)
    atomicAdd(t + static_cast<long long>(e) * C +
                  vote_of(sd, static_cast<uint32_t>(e), v, C),
              stake);
}

// The RANKS instance, launch 2. A block per (candidate chunk, lane x
// epoch), flattened.
__global__ void __launch_bounds__(RANK_THREADS)
dpos_rank_kernel(const int32_t* __restrict__ tallies,
                 int32_t* __restrict__ producers, int C, int K, int chunks) {
  __shared__ int32_t tile[RANK_THREADS];
  const long long be = blockIdx.x / chunks;
  const int c = static_cast<int>(blockIdx.x - be * chunks) * RANK_THREADS +
                static_cast<int>(threadIdx.x);
  const int32_t* t = tallies + be * C;
  const int32_t key = c < C ? neg_i32(t[c]) : 0;
  int rank = 0;
  for (int j0 = 0; j0 < C; j0 += RANK_THREADS) {
    if (__syncthreads_and(c >= C || rank >= K)) break;
    if (j0 + static_cast<int>(threadIdx.x) < C)
      tile[threadIdx.x] = neg_i32(t[j0 + threadIdx.x]);
    __syncthreads();
    const int n = min(RANK_THREADS, C - j0);
    for (int k = 0; k < n; ++k) {
      const int32_t kj = tile[k];
      rank += (kj < key) || (kj == key && j0 + k < c);
    }
  }
  if (c < C && rank < K) producers[be * K + rank] = c;
}

int rank_schedule(const uint32_t* seeds, int32_t* producers,
                  int32_t* tallies, int B, int E, int V, int C, int K,
                  cudaStream_t st) {
  const long long be = static_cast<long long>(B) * E;
  int err = static_cast<int>(cudaMemsetAsync(
      tallies, 0, static_cast<size_t>(be) * C * sizeof(int32_t), st));
  if (err != 0) return err;
  const long long total = static_cast<long long>(B) * V;
  dpos_tally_kernel<<<static_cast<unsigned>(
                          (total + RANK_THREADS - 1) / RANK_THREADS),
                      RANK_THREADS, 0, st>>>(seeds, tallies, E, V, C, total);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const int chunks = (C + RANK_THREADS - 1) / RANK_THREADS;
  dpos_rank_kernel<<<static_cast<unsigned>(be * chunks), RANK_THREADS, 0,
                     st>>>(tallies, producers, C, K, chunks);
  return static_cast<int>(cudaGetLastError());
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

extern "C" int ctt_dpos_schedule(const uint32_t* seeds, int32_t* producers,
                                 int32_t* tallies, int32_t* partials, int B,
                                 int E, int V, int C, int K, int G,
                                 cudaStream_t st) {
  if (C < 1 || K < 1 || K > C || V < C ||
      (partials != nullptr && (C > KEYS_MAX_C || G < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || E == 0) return 0;
  if (partials == nullptr)
    return rank_schedule(seeds, producers, tallies, B, E, V, C, K, st);
  const int eg = min(E, SMEM_MAX / static_cast<int>(sizeof(unsigned) * C));
  const size_t smem1 = sizeof(unsigned) * static_cast<size_t>(eg) * C;
  int err = set_smem(reinterpret_cast<const void*>(dpos_partial_kernel),
                     smem1);
  if (err != 0) return err;
  const long long blocks1 = static_cast<long long>(B) * G;
  if (blocks1 > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  dpos_partial_kernel<<<static_cast<unsigned>(blocks1), THREADS, smem1,
                        st>>>(seeds, reinterpret_cast<unsigned*>(partials),
                              E, V, C, G, (V + G - 1) / G, eg);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  int cs = 1;  // a block sums CLUSTER_SLICE candidates or more
  while (cs < MAX_CLUSTER && cs * CLUSTER_SLICE < C) cs <<= 1;
  const int slice = (C + cs - 1) / cs;
  const int kk = min(K, slice);
  const size_t smem2 =
      (sizeof(u64) + sizeof(unsigned)) *
      (static_cast<size_t>(slice) + static_cast<size_t>(cs) * kk);
  if ((err = set_smem(reinterpret_cast<const void*>(dpos_top_kernel),
                      smem2)) != 0)
    return err;
  const long long blocks2 = static_cast<long long>(B) * E * cs;
  if (blocks2 > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks2));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cs);
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, dpos_top_kernel, reinterpret_cast<const unsigned*>(partials),
      producers, tallies, E, C, K, G, kk));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
