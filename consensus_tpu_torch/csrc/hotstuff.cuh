// What the HotStuff round's kernels (KAJ hotstuff_prologue, KAD
// hotstuff_propose, KAE hotstuff_vote, KAF hotstuff_learn) share: the words
// of the state's `lane` leaf, which carry each lane-wide step of the round
// across a launch, and the SPEC §2 broadcast-row delivery test with its
// SPEC §A.2 retransmissions.
//
// lane is [B, LANE_WORDS] int64 (engines/hotstuff.py), and each word has one
// writer pattern a round, ordered by the launches (KAJ on rounds with a gate
// on, then KAD, then KAE, then KAF):
//   TOP        P1's key of the views at round entry on a flat round, (view
//              << 32) | (N - 1 - id) at its largest: KAD reads it; KAE's
//              last block of the lane empties it (INT64_MIN); KAF's blocks
//              atomicMax the new views' keys into it for the next round.
//              On a crash round (KAF's CRASH instance) only the nodes up at
//              the round's end go into it, and it serves the view spread
//              alone: KAD reads KEY on every round of a gated run.
//   VMAX       KAD's atomicMax of the proposers' views (V*); at rest -1.
//   VOTES      KAE's atomicAdd of the delivered votes; at rest 0.
//   DONE_VOTE  KAE's finished blocks of the lane; at rest 0.
//   VSTAR      V*, written by KAE's last block for KAF.
//   COUNTED    the vote count, written by KAE's last block for KAF.
//   VMIN       KAF's atomicMin of the new views (telemetry; CRASH: of the
//              nodes up at the round's end); at rest INT64_MAX.
//   DONE_LEARN KAF's finished blocks of the lane (telemetry); at rest 0.
//   KEY        P1's key on a round with a SPEC §6c or §B gate on: KAJ's
//              atomicMax of the keys of the views after its prologue, over
//              the nodes up this round; KAD reads it; KAE's last block
//              leaves it at rest, KEY_REST = -1, which reads as vM = -1 and
//              M = N (no live node: no gossip). TOP cannot serve here: KAF
//              leaves it full, and the prologue moves views after KAF.
//   VOTES1     KAE's atomicAdd of the delivered votes for variant 1 under
//              SPEC §7c equivocation; at rest 0.
//   QCF        the round's QC (bit 0) and forked QC (bit 1) under
//              equivocation, written by KAE's last block for KAF.
//   FBIT       the fork bit the deceived nodes take (0: no new fork-table
//              row), written by KAE's last block for KAF.
//   CONF       KAF's atomicAdd of the conflicting commits under
//              equivocation (telemetry); at rest 0.
// With byzantine nodes (SPEC §3c/§7c) every P1 key (TOP, KEY) and the view
// spread (VMIN, and TOP's high word) take the honest nodes only: the ids
// below N - nb, fixed for a run.
// A kernel that accumulates into a word leaves it at rest after the last
// block of its lane has read it, so a round needs no memset: the "fresh
// outputs against in-round hazards" rule holds because no block reads a word
// that another block of the same launch writes, except through the atomics
// and the last-block-done count (__threadfence before and after).
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace hs {

constexpr int TOP = 0;
constexpr int VMAX = 1;
constexpr int VOTES = 2;
constexpr int DONE_VOTE = 3;
constexpr int VSTAR = 4;
constexpr int COUNTED = 5;
constexpr int VMIN = 6;
constexpr int DONE_LEARN = 7;
constexpr int KEY = 8;
constexpr int VOTES1 = 9;
constexpr int QCF = 10;
constexpr int FBIT = 11;
constexpr int CONF = 12;
constexpr int LANE_WORDS = 13;
constexpr long long KEY_REST = -1;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr long long I64_MIN = -0x7FFFFFFFFFFFFFFFll - 1;
constexpr long long I64_MAX = 0x7FFFFFFFFFFFFFFFll;

// int32 arithmetic that wraps, as the JAX package's does.
__device__ __forceinline__ int32_t add_i32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub_i32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// v mod n with the sign of n (jnp's and PyTorch's %), for n >= 1.
__device__ __forceinline__ int32_t floor_mod(int32_t v, int32_t n) {
  const int32_t m = v % n;
  return m < 0 ? m + n : m;
}

// P1's key of node `id`'s view: the largest key is the highest view, and
// among equal views the lowest id.
__device__ __forceinline__ long long view_key(int32_t view, int id, int n) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<long long>(view)) << 32) |
      static_cast<uint32_t>(n - 1 - id));
}

// A lane's broadcast row from node `src` in round r: the mixer state after
// absorbing (seed ^ STREAM_DELIVER, r, src), the round's partition event
// and src's side. The gossip row (P1) and the proposal row (P2) from one
// sender draw the same words: the model's per-(round, edge) link state,
// delayed retransmissions included.
struct Row {
  uint32_t src;    // the sender
  uint32_t h;      // mix_absorb(mix_absorb(seed ^ DELIVER, r), src)
  bool part;       // the round's partition is active
  uint32_t side;   // src's side, where part
};

__device__ __forceinline__ Row row_from(uint32_t seed, uint32_t r,
                                        uint32_t src, uint32_t part_cut) {
  Row row;
  row.src = src;
  row.h = ctt::mix_absorb(ctt::mix_absorb(seed ^ ctt::STREAM_DELIVER, r), src);
  // An exact shortcut: without a partition cutoff no round's partition
  // is active, and the side draws are never read.
  row.part = part_cut != 0u &&
             ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 0u, 0u) < part_cut;
  row.side = row.part
                 ? ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 1u, src) & 1u
                 : 0u;
  return row;
}

// Whether row `row` reaches node j: the mixer's draw of edge (src, j) is not
// below drop_cut, or (max_delay > 0) a flight lost on that edge in one of
// the last max_delay rounds arrives now (K13 delayed_open, drawn only where
// the round's own draw dropped; its prefix (seed ^ DELAY, q, d) differs from
// the row's, so nothing of the row's hoist is reused; only in the DELAY
// instances of KAD and KAE, which their launches pick when max_delay > 0),
// and, where the partition is active, j drew src's side.
template <bool DELAY>
__device__ __forceinline__ bool row_open(const Row& row, uint32_t seed,
                                         uint32_t r, uint32_t j,
                                         uint32_t drop_cut,
                                         uint32_t max_delay) {
  if (ctt::mix_fin(ctt::mix_absorb(row.h, j)) < drop_cut &&
      !(DELAY && ctt::delayed_open(seed, r, row.src, j, drop_cut, max_delay)))
    return false;
  return !row.part ||
         (ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 1u, j) & 1u) ==
             row.side;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ long long warp_max64(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_down_sync(FULL, v, o);
    v = u > v ? u : v;
  }
  return v;
}

}  // namespace hs
