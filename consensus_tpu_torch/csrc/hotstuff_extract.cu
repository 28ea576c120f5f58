// Kernel KAG: a chained HotStuff run's decided logs (SPEC §7b, §7c),
// materialized once from the carry after the last round.
//
// Replaces: consensus_tpu/engines/hotstuff.py _block_val (K18, lines 183-192)
// and _extract (lines 544-569). Node i of a lane committed heights [0,
// clen[i]); the value at height s is the block value of (chain_v[s], s):
// bitcast_i32(threefry(seed ^ STREAM_VALUE, chain_v[s], sub, s)) with sub 6
// where chain_vid[s] == 1 (the §7c second variant), else 5. Then each fork
// entry k < fnum, in order (a later entry wins), overlays the variant-6 value
// of (ftab_v[k], ftab_h[k]) at height ftab_h[k] on every committed node
// holding bit k of fvec: the deceived nodes of a forked QC. The extraction
// is a pure function of the carry and is held whole: flat runs always have
// fnum = 0, and an equivocating JAX carry converted to the port's state
// exercises the overlays.
//
// Bound: bytes. The [B, N, S] committed flags (1 byte) and values (4 bytes)
// are written once: 256 MB at hotstuff-100k (B = 8, N = 100 000, S = 64), 76
// us at 3.35 TB/s; the block values are one Threefry draw a (lane, height),
// shared by every node.
// Design: a block per tile of a lane's rows and of its heights (at most
// CHUNK heights, so that any S fits: one tile of heights at S = 64), the
// (lane, row tile, height tile) triples flattened into gridDim.x. The block
// first draws its heights' block values and the lane's fork entries into
// shared memory, then a thread per (row, height) of the tile, consecutive
// threads on consecutive heights of a row (coalesced stores), writes the
// flag and the value. No atomics: every element has one writer.
#include <cuda_runtime.h>

#include "hotstuff.cuh"

namespace {

constexpr int CHUNK = 4096;          // heights a block covers at most
constexpr int PER_BLOCK = 4096;      // (row, height) elements a block
constexpr int FORK_TABLE = 8;

__device__ __forceinline__ int32_t block_val(uint32_t seed, int32_t view,
                                             uint32_t sub, int32_t slot) {
  return static_cast<int32_t>(
      ctt::random_u32(seed, ctt::STREAM_VALUE, static_cast<uint32_t>(view),
                      sub, static_cast<uint32_t>(slot)));
}

__global__ void __launch_bounds__(hs::THREADS)
hotstuff_extract_kernel(const uint32_t* __restrict__ seed,
                        const int32_t* __restrict__ chain_v,
                        const int32_t* __restrict__ chain_vid,
                        const int32_t* __restrict__ clen,
                        const int32_t* __restrict__ fvec,
                        const int32_t* __restrict__ ftab_v,
                        const int32_t* __restrict__ ftab_h,
                        const int32_t* __restrict__ fnum,
                        bool* __restrict__ committed,
                        int32_t* __restrict__ dval, int N, int S, int rows,
                        int row_tiles, int chunks) {
  __shared__ int32_t s_val[CHUNK];
  __shared__ int32_t s_fh[FORK_TABLE], s_fv[FORK_TABLE];
  __shared__ int s_nf;
  const int per_lane = row_tiles * chunks;
  const int b = blockIdx.x / per_lane;
  const int rest = blockIdx.x - b * per_lane;
  const int rt = rest / chunks;
  const int c0 = (rest - rt * chunks) * CHUNK;
  const int width = min(CHUNK, S - c0);
  const int i0 = rt * rows;
  const int n_rows = min(rows, N - i0);
  const uint32_t sd = seed[b];
  const long long lane_s = static_cast<long long>(b) * S;
  for (int k = threadIdx.x; k < width; k += hs::THREADS) {
    const int s = c0 + k;
    s_val[k] = block_val(sd, chain_v[lane_s + s],
                         chain_vid[lane_s + s] == 1 ? 6u : 5u, s);
  }
  if (threadIdx.x < FORK_TABLE) {
    const int k = threadIdx.x;
    const int32_t hh = ftab_h[b * FORK_TABLE + k];
    s_fh[k] = hh;
    s_fv[k] = block_val(sd, ftab_v[b * FORK_TABLE + k], 6u, hh);
  }
  if (threadIdx.x == 0) s_nf = min(max(fnum[b], 0), FORK_TABLE);
  __syncthreads();
  const int nf = s_nf;
  const int n = n_rows * width;
  for (int e = threadIdx.x; e < n; e += hs::THREADS) {
    const int ri = e / width;
    const int k = e - ri * width;
    const int i = i0 + ri;
    const int s = c0 + k;
    const long long node = static_cast<long long>(b) * N + i;
    const bool c = s < clen[node];
    int32_t v = c ? s_val[k] : 0;
    if (c && nf > 0) {
      const int32_t bits = fvec[node];
      for (int f = 0; f < nf; ++f)
        if (((bits >> f) & 1) && s == s_fh[f]) v = s_fv[f];
    }
    const long long at = node * S + s;
    committed[at] = c;
    dval[at] = v;
  }
}

}  // namespace

// committed ([B, N, S] bool) and dval ([B, N, S] int32) are written whole.
extern "C" int ctt_hotstuff_extract(const uint32_t* seed,
                                    const int32_t* chain_v,
                                    const int32_t* chain_vid,
                                    const int32_t* clen, const int32_t* fvec,
                                    const int32_t* ftab_v,
                                    const int32_t* ftab_h,
                                    const int32_t* fnum, bool* committed,
                                    int32_t* dval, int B, int N, int S,
                                    cudaStream_t st) {
  if (B == 0 || N == 0 || S == 0) return 0;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  const int rows = max(1, PER_BLOCK / min(S, CHUNK));
  const int row_tiles = (N + rows - 1) / rows;
  const long long blocks = static_cast<long long>(B) * row_tiles * chunks;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  hotstuff_extract_kernel<<<static_cast<unsigned>(blocks), hs::THREADS, 0,
                            st>>>(seed, chain_v, chain_vid, clen, fvec,
                                  ftab_v, ftab_h, fnum, committed, dval, N, S,
                                  rows, row_tiles, chunks);
  return static_cast<int>(cudaGetLastError());
}
