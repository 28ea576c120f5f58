// What the Paxos kernels (paxos_promise.cu, paxos_accept_learn.cu) share: a
// proposer's round values, the layout of their per-proposer scratch, and
// the launch shapes. A row block of KY keeps its per-slot values in shared
// memory when they fit in ROW_SMEM_MAX, else in a row of an output it
// writes last; KZ's launches take their shared memory under the same cap.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"

namespace ctt {

// Rows of KY's [B, 4, N] int32 per-proposer scratch; KZ's keeps its flags
// in the same row (paxos_accept_learn.cu lays out the others).
constexpr int PROP_SLOT = 0;    // slot_p: draw(VALUE, r, 1, p) mod S
constexpr int PROP_BALLOT = 1;  // r * N + p + 1, wrapping
constexpr int PROP_FLAG = 2;    // is_prop (KY); proceed, then decided (KZ)
constexpr int PROP_VALUE = 3;   // v_own (KY)

// Dynamic shared memory a row block may take (the H100 allows 227 KB).
constexpr int ROW_SMEM_MAX = 200 * 1024;
// Rows a tile block walks for each of its proposers.
constexpr int TILE_ROWS = 64;
constexpr int THREADS = 256;

// A tile block's place: blocks of THREADS proposers by TILE_ROWS acceptor
// rows by lanes, flattened in that order into gridDim.x (gridDim.y and .z
// stop at 65 535).
struct TileBlock {
  int p;   // this thread's proposer
  int a0;  // the tile's first acceptor row
  int b;   // the lane
};

inline unsigned tile_blocks(int B, int N) {
  const long long chunks = (N + THREADS - 1) / THREADS;
  const long long rows = (N + TILE_ROWS - 1) / TILE_ROWS;
  return static_cast<unsigned>(chunks * rows * B);
}

__device__ __forceinline__ TileBlock tile_block(int N) {
  const int chunks = (N + THREADS - 1) / THREADS;
  const int rows = (N + TILE_ROWS - 1) / TILE_ROWS;
  const long long t = blockIdx.x / chunks;
  TileBlock out;
  out.p = static_cast<int>(blockIdx.x - t * chunks) * THREADS +
          static_cast<int>(threadIdx.x);
  out.b = static_cast<int>(t / rows);
  out.a0 = static_cast<int>(t - static_cast<long long>(out.b) * rows) *
           TILE_ROWS;
  return out;
}

struct Proposal {
  bool is_prop;
  int32_t slot;
  int32_t ballot;
  int32_t v_own;
};

// Proposer p's round-r values in the lane of seed `sd` (consensus_tpu/
// engines/paxos.py paxos_round lines 95-126): it proposes when p < P and
// the round's churn event did not fire.
__device__ __forceinline__ Proposal proposal(uint32_t sd, uint32_t r, int p,
                                             int P, uint32_t churn_cut, int N,
                                             int S) {
  const uint32_t up = static_cast<uint32_t>(p);
  Proposal out;
  out.is_prop =
      p < P && !(random_u32(sd, STREAM_CHURN, r, 0u, 0u) < churn_cut);
  out.slot = static_cast<int32_t>(random_u32(sd, STREAM_VALUE, r, 1u, up) %
                                  static_cast<uint32_t>(S));
  out.ballot =
      static_cast<int32_t>(r * static_cast<uint32_t>(N) + up + 1u);
  out.v_own = static_cast<int32_t>(random_u32(sd, STREAM_VALUE, r, 0u, up));
  return out;
}

}  // namespace ctt
