// Kernel KV: SPEC §6b P6 decide gossip and P7 timers of the broadcast PBFT
// round at every node of each lane.
//
// Replaces: consensus_tpu/engines/pbft_bcast.py pbft_bcast_round (K15)
// lines 630-675 on its flat path, and the same phases of
// consensus_tpu/engines/pbft_sweep.py pbft_bcast_round_padded (K17) lines
// 460-485: per (lane, slot, side) the decider is the least-id sender of
// that side (bit 0 and bit 1 of the node byte KT wrote) that has
// committed the slot as P5 left it; a node that has not committed the
// slot adopts its side's decider's decided value (padded nodes too, as in
// the JAX package: nothing reads their rows); then a node that committed
// a slot this round, against the round's entry, sets its timer to 0,
// another whose P0-P2 reset it keeps it, and the rest count it up.
//
// Bound: bytes. Each (node, slot) reads committed, dval and the entry's
// committed and writes committed and dval (11 bytes); each node reads its
// byte, timer and reset flag and writes its timer (10 bytes). The
// deciders' search reads committed down to the first decider of each
// (slot, side) at most, already counted. At pbft-100k-bcast (B = 8, N =
// 100 000, S = 16) that is about 149 MB a round, 44 us at 3.35 TB/s.
// Design: two launches on the stream, after a memset of the minima.
// Lanes and node tiles share the grid's x (lane x / tiles), so the lane
// count has no grid limit of its own.
//  1. A block per 1024 nodes of a lane and group of up to 256 slots; each
//     thread owns a slot and walks the block's nodes in id order at a
//     stride, stopping at its first decider of each side; the block's
//     minima meet in shared memory and leave by one atomicMin a (slot,
//     side). The minima start at 0x7F7F7F7F (the memset's byte), above
//     every node id.
//  2. A group of threads per node (as many as its slots, up to a warp;
//     four nodes in turn) reads its side's decider of each slot and the
//     decider's value (a few rows a lane, cached), writes fresh outputs,
//     so no adoption is read the same round, and runs P7 off a ballot of
//     the group.
// Its CRASH instance (SPEC §6c, picked by the launch's `crash` argument)
// keeps a node of bit 2 (down at the round's end) from adopting
// (pbft_bcast.py:663-664); such a node is no decider either, since KT
// cleared its bit 0.
// Its BYZ instance (SPEC §3c, picked when n_real is given, with byzantine
// nodes in either mode) takes the honest senders only as deciders (node i
// of a lane is honest when i < n_real - nb; pbft_bcast.py:650,
// pbft_sweep.py:461): bit 0 says that a node's broadcast goes out, honest
// or not.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;  // launch 2's nodes a thread group
constexpr int CHUNK = 1024;  // nodes a block
constexpr int MAX_SG = 256;  // slots a block
constexpr int NONE = 0x7F7F7F7F;

// Launch 1. Grid (B * tiles, 1, slot groups), tiles = ceil(N / CHUNK).
template <bool BYZ>
__global__ void __launch_bounds__(THREADS)
decide_min_kernel(const uint8_t* __restrict__ bits,
                  const bool* __restrict__ committed,
                  int* __restrict__ imin, int N, int S, int tiles,
                  const int32_t* __restrict__ n_real, int nb) {
  __shared__ int low[MAX_SG][2];
  const int SG = S < MAX_SG ? S : MAX_SG;
  const int P = THREADS / SG;
  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int sl = t % SG;
  const int s = blockIdx.z * SG + sl;
  const bool on = t < P * SG && s < S;
  for (int k = t; k < SG * 2; k += THREADS) (&low[0][0])[k] = NONE;
  __syncthreads();
  if (on) {
    const long long nodes = static_cast<long long>(b) * N;
    const int i0 = (blockIdx.x - b * tiles) * CHUNK;
    const int i1 = min(i0 + CHUNK, N);
    // BYZ: the senders from the first byzantine id up decide nothing.
    const int top = BYZ ? min(i1, n_real[b] - nb) : i1;
    int first[2] = {NONE, NONE};
    for (int i = i0 + t / SG; i < top; i += P) {
      const uint8_t bi = bits[nodes + i];
      const int side = (bi >> 1) & 1;
      if ((bi & 1) && first[side] == NONE && committed[(nodes + i) * S + s])
        first[side] = i;
      if (first[0] != NONE && first[1] != NONE) break;
    }
    if (first[0] != NONE) atomicMin(&low[sl][0], first[0]);
    if (first[1] != NONE) atomicMin(&low[sl][1], first[1]);
  }
  __syncthreads();
  for (int k = t; k < SG * 2; k += THREADS) {
    const int ss = blockIdx.z * SG + k / 2;
    const int v = (&low[0][0])[k];
    if (ss < S && v != NONE)
      atomicMin(&imin[(static_cast<long long>(b) * 2 + (k & 1)) * S + ss], v);
  }
}

// Launch 2. Grid B * tiles, tiles = ceil(N * G / (THREADS * PER_THREAD)).
// A group of G
// threads per node: G is the least power of two >= S, at most 32, so a
// warp holds 32 / G nodes and a group's threads read consecutive slots; a
// thread takes slots sl, sl + G, ... of PER_THREAD nodes in turn.
template <bool CRASH>
__global__ void __launch_bounds__(THREADS)
decide_adopt_kernel(const uint8_t* __restrict__ bits,
                    const bool* __restrict__ committed,
                    const int32_t* __restrict__ dval,
                    const bool* __restrict__ committed_start,
                    const int32_t* __restrict__ timer,
                    const bool* __restrict__ reset,
                    const int* __restrict__ imin,
                    bool* __restrict__ com_out,
                    int32_t* __restrict__ dval_out,
                    int32_t* __restrict__ timer_out, int N, int S,
                    int log_g, int tiles) {
  const int G = 1 << log_g;
  const int groups = THREADS >> log_g;  // nodes a block takes at a time
  const int sl = threadIdx.x & (G - 1);
  const int first = (threadIdx.x & 31) & ~(G - 1);
  const unsigned group = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << first;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const long long nodes = static_cast<long long>(b) * N;
  // Every node's first slot (sl), timer and reset flag are loaded before
  // any is used; further slots (S > 32) are walked after.
  int j[PER_THREAD];
  bool c[PER_THREAD], cs[PER_THREAD], rs[PER_THREAD];
  int32_t dv[PER_THREAD], tm[PER_THREAD];
  uint8_t bj[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    j[u] = (tile * PER_THREAD + u) * groups + (threadIdx.x >> log_g);
    const bool in = j[u] < N && sl < S;
    const long long e = (nodes + j[u]) * S + sl;
    bj[u] = j[u] < N ? bits[nodes + j[u]] : 0;
    c[u] = in && committed[e];
    cs[u] = in && committed_start[e];
    dv[u] = in ? dval[e] : 0;
    const bool lead = j[u] < N && sl == 0;
    tm[u] = lead ? timer[nodes + j[u]] : 0;
    rs[u] = lead && reset[nodes + j[u]];
  }
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const bool live = j[u] < N;  // every thread takes part in the ballot
    const long long row = nodes + j[u];
    bool changed = false;
    if (live) {
      const int* low =
          imin + (static_cast<long long>(b) * 2 + ((bj[u] >> 1) & 1)) * S;
      for (int s = sl; s < S; s += G) {
        const long long e = row * S + s;
        bool cc = c[u];
        int32_t d = dv[u];
        bool start = cs[u];
        if (s != sl) {
          cc = committed[e];
          d = dval[e];
          start = committed_start[e];
        }
        if (!cc && !(CRASH && (bj[u] & 4))) {
          const int i = low[s];
          if (i < N) {
            cc = true;
            d = dval[(nodes + i) * S + s];
          }
        }
        com_out[e] = cc;
        dval_out[e] = d;
        changed |= cc && !start;
      }
    }
    // P7 timers: a slot of the node changed in any thread of its group.
    const unsigned all = __ballot_sync(0xFFFFFFFFu, changed);
    if (live && sl == 0)
      timer_out[row] = (all & group) ? 0
                       : rs[u]
                           ? tm[u]
                           : static_cast<int32_t>(
                                 static_cast<uint32_t>(tm[u]) + 1u);
  }
}

}  // namespace

// imin is scratch, [B, 2, S] int32, set here. n_real is null on the flat
// path; with byzantine nodes it is [B] int32 and nb their count.
extern "C" int ctt_bcast_decide(const uint8_t* bits, const bool* committed,
                                const int32_t* dval,
                                const bool* committed_start,
                                const int32_t* timer, const bool* reset,
                                bool* com_out, int32_t* dval_out,
                                int32_t* timer_out, int* imin, int B, int N,
                                int S, int crash, const int32_t* n_real,
                                int nb, cudaStream_t st) {
  if (nb < 0 || nb > N) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  int err = 0;
  if (S > 0) {
    err = static_cast<int>(cudaMemsetAsync(
        imin, 0x7F, sizeof(int) * 2 * static_cast<size_t>(B) * S, st));
    if (err != 0) return err;
    const int SG = S < MAX_SG ? S : MAX_SG;
    const int tiles = (N + CHUNK - 1) / CHUNK;
    const int groups = (S + SG - 1) / SG;
    if (static_cast<long long>(tiles) * B > 0x7FFFFFFFLL || groups > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(tiles * B), 1u,
                    static_cast<unsigned>(groups));
    const auto minima = n_real != nullptr ? decide_min_kernel<true>
                                          : decide_min_kernel<false>;
    minima<<<grid, THREADS, 0, st>>>(bits, committed, imin, N, S, tiles,
                                     n_real, nb);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  int log_g = 0;
  while ((1 << log_g) < S && log_g < 5) ++log_g;
  const long long threads = static_cast<long long>(N) << log_g;
  const long long tile = static_cast<long long>(THREADS) * PER_THREAD;
  const long long tiles = (threads + tile - 1) / tile;
  if (tiles * B > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto adopt =
      crash ? decide_adopt_kernel<true> : decide_adopt_kernel<false>;
  adopt<<<static_cast<unsigned>(tiles * B), THREADS, 0, st>>>(
      bits, committed, dval, committed_start, timer, reset, imin, com_out,
      dval_out, timer_out, N, S, log_g, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
