// SPEC §9 switch delivery as __device__ functions (K21,
// consensus_tpu/ops/aggregate.py; the oracle's cpp/oracle.cpp AggNet): the
// per-(round, aggregator) fault draws that kernel KAL (agg_round.cu) writes
// into the round's [B, K] table, a node's uplink, which KAL writes into the
// [B, phases, N] uplink masks, and an aggregator's downlink, which the SWITCH
// instances of KB, KM, KY, KZ and KAE draw inline from the table.
//
// Keying: aggregator a of phase ph is the delivery mixer's vertex
// N + ph*K + a (ids >= N: never a node's), whose partition side is keyed on
// the phase-free vertex N + a. The uplink of node i is the §2 draw (q, i, g)
// with the §A.2 retransmission and the partition at the round q of its
// aggregator (aggregate.py:280-297); the downlink is (r, g, dst) with the
// retransmission and the partition at r, masked by the aggregator being
// alive (:326-345). A segment is a(i) = i / ceil(N / K).
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace ctt {

constexpr uint32_t STREAM_AGG = 0x510E527Fu;
constexpr uint32_t STREAM_POISON = 0x6A09E667u;

// Bits of a table word (ops/aggregate.py AGG_ALIVE, AGG_SIDE, AGG_POISON0):
// alive, partition side of N + a at round r, poisoned in phase ph (bit
// AGG_POISON0 << ph).
constexpr int32_t AGG_ALIVE = 1;
constexpr int32_t AGG_SIDE = 2;
constexpr int32_t AGG_POISON0 = 4;

// What a SWITCH instance reads: KAL's uplink masks [B, phases, N] and table
// [B, K], and the geometry (a segment is a(i) = i / seg, seg = ceil(N / K)).
struct Agg {
  const unsigned char* up;
  const int32_t* tab;
  int K;       // aggregators
  int seg;     // segment width ceil(N / K)
  int phases;  // rows of up per lane
};

// The segment width ceil(N / K): node i's aggregator is i / agg_seg(N, K).
__host__ __device__ __forceinline__ int agg_seg(int N, int K) {
  return (N + K - 1) / K;
}

// The §2 drop leg with the §A.2 retransmission on edge src -> dst at round q.
__device__ __forceinline__ bool edge_open(uint32_t sd, uint32_t q,
                                          uint32_t src, uint32_t dst,
                                          uint32_t drop_cut,
                                          uint32_t max_delay) {
  return delivery_u32(sd, q, src, dst) >= drop_cut ||
         (max_delay != 0u && delayed_open(sd, q, src, dst, drop_cut,
                                          max_delay));
}

// Whether round q's partition is active (never without partitions).
__device__ __forceinline__ bool part_on(uint32_t sd, uint32_t q,
                                        uint32_t part_cut) {
  return part_cut != 0u &&
         random_u32(sd, STREAM_PARTITION, q, 0u, 0u) < part_cut;
}

// The partition side of vertex id at round q.
__device__ __forceinline__ uint32_t part_side(uint32_t sd, uint32_t q,
                                              uint32_t id) {
  return random_u32(sd, STREAM_PARTITION, q, 1u, id) & 1u;
}

// Aggregator a's uplink round: r - d where it serves stale state at depth
// d = 1 + draw(r, 2, a) % max_stale and r >= d, else r (aggregate.py:104-111).
__device__ __forceinline__ uint32_t agg_q(uint32_t sd, uint32_t r, uint32_t a,
                                          uint32_t stale_cut,
                                          uint32_t max_stale) {
  if (stale_cut == 0u || random_u32(sd, STREAM_AGG, r, 1u, a) >= stale_cut)
    return r;
  const uint32_t d = 1u + random_u32(sd, STREAM_AGG, r, 2u, a) % max_stale;
  return r >= d ? r - d : r;
}

// Node i's uplink to its aggregator a in phase ph, at the aggregator's round
// q (aggregate.py:280-311).
__device__ __forceinline__ bool agg_uplink(uint32_t sd, uint32_t q,
                                           uint32_t N, uint32_t K,
                                           uint32_t ph, uint32_t a,
                                           uint32_t i, uint32_t drop_cut,
                                           uint32_t part_cut,
                                           uint32_t max_delay) {
  if (!edge_open(sd, q, i, N + ph * K + a, drop_cut, max_delay)) return false;
  return !part_on(sd, q, part_cut) ||
         part_side(sd, q, i) == part_side(sd, q, N + a);
}

// The §6b uplink of node i (aggregate.py:313-323): its one broadcast draw,
// key (q, i, i), at its aggregator a's round q, with the partition against
// vertex N + a (N: the lane's vertex base).
__device__ __forceinline__ bool agg_uplink_bcast(uint32_t sd, uint32_t q,
                                                 uint32_t N, uint32_t a,
                                                 uint32_t i, uint32_t drop_cut,
                                                 uint32_t part_cut,
                                                 uint32_t max_delay) {
  if (!edge_open(sd, q, i, i, drop_cut, max_delay)) return false;
  return !part_on(sd, q, part_cut) ||
         part_side(sd, q, i) == part_side(sd, q, N + a);
}

// The mixer's prefix of the SPEC §2 draw of (r, g, dst) for an aggregator
// vertex g = N + ph*K + a, hoisted out of a loop over receivers: the draw is
// fmix(absorb(downlink_prefix(seed, r, g), dst)).
__device__ __forceinline__ uint32_t downlink_prefix(uint32_t sd, uint32_t r,
                                                    uint32_t g) {
  return mix_absorb(mix_absorb(sd ^ STREAM_DELIVER, r), g);
}

// Aggregator vertex g's downlink to receiver dst at round r, from its table
// word and its prefix hg: alive, where the round's partition is active
// (part) dst's side side_dst is the aggregator's, and the §2 draw open or
// (max_delay > 0) a dropped flight of the last max_delay rounds arriving.
__device__ __forceinline__ bool agg_downlink(uint32_t sd, uint32_t r,
                                               uint32_t hg, uint32_t g,
                                               uint32_t dst, int32_t word,
                                               uint32_t drop_cut,
                                               uint32_t max_delay, bool part,
                                               uint32_t side_dst) {
  if (!(word & AGG_ALIVE)) return false;
  if (part && ((word & AGG_SIDE) != 0) != (side_dst != 0u)) return false;
  return mix_fin(mix_absorb(hg, dst)) >= drop_cut ||
         (max_delay != 0u && delayed_open(sd, r, g, dst, drop_cut,
                                          max_delay));
}

// A SWITCH instance's launch arguments: the tables and the draws' settings.
struct SwitchArgs {
  Agg g;
  uint32_t drop_cut, part_cut, max_delay;
};

inline SwitchArgs switch_args(const unsigned char* up, const int32_t* tab,
                              int K, int phases, int N, uint32_t drop_cut,
                              uint32_t part_cut, uint32_t max_delay) {
  SwitchArgs s;
  s.g.up = up;
  s.g.tab = tab;
  s.g.K = K;
  s.g.seg = up != nullptr ? agg_seg(N, K) : 1;
  s.g.phases = phases;
  s.drop_cut = drop_cut;
  s.part_cut = part_cut;
  s.max_delay = max_delay;
  return s;
}

// What a thread keeps for its receiver dst over a round's downlinks: the
// lane's seed and round, the partition's activity and dst's side.
struct SwitchLane {
  uint32_t sd, r, dst;
  bool part;
  uint32_t side;
};

__device__ __forceinline__ SwitchLane switch_lane(const SwitchArgs& s,
                                                  uint32_t sd, uint32_t r,
                                                  int dst) {
  SwitchLane l;
  l.sd = sd;
  l.r = r;
  l.dst = static_cast<uint32_t>(dst);
  l.part = part_on(sd, r, s.part_cut);
  l.side = l.part ? part_side(sd, r, l.dst) : 0u;
  return l;
}

// Aggregator ag's downlink to the receiver of l in phase ph (lane b of N
// nodes).
__device__ __forceinline__ bool switch_down(const SwitchArgs& s,
                                            const SwitchLane& l, long long b,
                                            int N, int ph, int ag) {
  const uint32_t g = static_cast<uint32_t>(N + ph * s.g.K + ag);
  return agg_downlink(l.sd, l.r, downlink_prefix(l.sd, l.r, g), g, l.dst,
                        s.g.tab[b * s.g.K + ag], s.drop_cut, s.max_delay,
                        l.part, l.side);
}

// SPEC §9b: byzantine node i claims a vote to its aggregator in round r
// (aggregate.py:154-178; STREAM_POISON c0 = 1).
__device__ __forceinline__ bool uplink_lie(uint32_t sd, uint32_t r,
                                           uint32_t i, uint32_t uplink_cut) {
  return random_u32(sd, STREAM_POISON, r, 1u, i) < uplink_cut;
}

}  // namespace ctt
