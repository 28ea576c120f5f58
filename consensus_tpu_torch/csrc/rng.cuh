// Counter-based RNG of the simulator as __device__ functions, shared by the
// kernels of this directory: Threefry-2x32 with 20 rounds (the JAX package's
// consensus_tpu/core/rng.py threefry2x32_jnp / random_u32_jnp) and the
// SPEC §2 murmur-style delivery mixer (mix_absorb_jnp / mix_fin_jnp /
// delivery_u32_jnp), with the SPEC §A.2 retransmission draw (delay_u32_jnp)
// and the delayed-retransmission term of consensus_tpu/ops/adversary.py
// (delayed_open, K13), and the SPEC §B timer skew of
// consensus_tpu/ops/viewsync.py (desync_skew, K22), and the one-engine gate
// draws of K13 and K20: the SPEC §A.1 slot miss, the §A.3 attack activation
// and the §A.4 window-keyed suppression. All arithmetic is uint32
// and wraps, which is the whole contract: the draws equal the JAX package's
// bit for bit.
#pragma once

#include <cstdint>

namespace ctt {

constexpr uint32_t STREAM_DELIVER = 0x9E3779B1u;
constexpr uint32_t STREAM_TIMEOUT = 0x85EBCA77u;
constexpr uint32_t STREAM_CHURN = 0xC2B2AE3Du;
constexpr uint32_t STREAM_PARTITION = 0x27D4EB2Fu;
constexpr uint32_t STREAM_STAKE = 0x165667B1u;
constexpr uint32_t STREAM_VOTE = 0xD3A2646Cu;
constexpr uint32_t STREAM_VALUE = 0xFD7046C5u;
constexpr uint32_t STREAM_DELAY = 0x2545F491u;
constexpr uint32_t STREAM_DESYNC = 0x5BE0CD19u;
constexpr uint32_t STREAM_SLOTMISS = 0x7F4A7C15u;
constexpr uint32_t STREAM_ATTACK = 0xBB67AE85u;
constexpr uint32_t STREAM_SUPPRESS = 0x1F83D9ABu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry_4(uint32_t& x0, uint32_t& x1, int a,
                                           int b, int c, int d) {
  x0 += x1; x1 = rotl32(x1, a) ^ x0;
  x0 += x1; x1 = rotl32(x1, b) ^ x0;
  x0 += x1; x1 = rotl32(x1, c) ^ x0;
  x0 += x1; x1 = rotl32(x1, d) ^ x0;
}

// First output word of Threefry-2x32 (20 rounds), key (k0, k1), counter
// (c0, c1).
__device__ __forceinline__ uint32_t threefry2x32_y0(uint32_t k0, uint32_t k1,
                                                    uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  threefry_4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  threefry_4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  threefry_4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  threefry_4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  threefry_4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  return x0;
}

// random_u32(seed ^ stream, ctx, c0, c1) of the JAX package.
__device__ __forceinline__ uint32_t random_u32(uint32_t seed, uint32_t stream,
                                               uint32_t ctx, uint32_t c0,
                                               uint32_t c1) {
  return threefry2x32_y0(seed ^ stream, ctx, c0, c1);
}

// Election timeout of node `node` under `term` (engines/raft.py
// draw_timeout): t_min + threefry(seed ^ TIMEOUT, term, 0, node) mod t_span,
// wrapped to int32 as the plain version's cast does.
__device__ __forceinline__ int32_t draw_timeout(uint32_t seed, int32_t term,
                                                int32_t node, int32_t t_min,
                                                uint32_t t_span) {
  const uint32_t d = random_u32(seed, STREAM_TIMEOUT,
                                static_cast<uint32_t>(term), 0u,
                                static_cast<uint32_t>(node));
  return static_cast<int32_t>(static_cast<uint32_t>(t_min) + d % t_span);
}

__device__ __forceinline__ uint32_t mix_absorb(uint32_t h, uint32_t c) {
  uint32_t k = c * 0xCC9E2D51u;
  k = rotl32(k, 15) * 0x1B873593u;
  h = rotl32(h ^ k, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t mix_fin(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The SPEC §2 delivery draw of edge i -> j in round r.
__device__ __forceinline__ uint32_t delivery_u32(uint32_t seed, uint32_t r,
                                                 uint32_t i, uint32_t j) {
  return mix_fin(mix_absorb(
      mix_absorb(mix_absorb(seed ^ STREAM_DELIVER, r), i), j));
}

// The SPEC §A.2 retransmission draw of the flight sent on edge i -> j in
// round q and delayed by d rounds (consensus_tpu/core/rng.py delay_u32_jnp).
__device__ __forceinline__ uint32_t delay_u32(uint32_t seed, uint32_t q,
                                              uint32_t d, uint32_t i,
                                              uint32_t j) {
  return mix_fin(mix_absorb(
      mix_absorb(mix_absorb(mix_absorb(seed ^ STREAM_DELAY, q), d), i), j));
}

// K13 delayed_open (consensus_tpu/ops/adversary.py:38-57; the oracle's
// cpp/threefry.h:101-111): whether a flight dropped on edge i -> j at some
// round q = r - d, d in 1..max_delay, arrives at round r: the base draw at q
// dropped it and its retransmission draw survives the same cutoff. Rounds
// d > r do not exist, so q never wraps. Exact and short: the retransmission
// is drawn only where the base draw at q dropped, and the loop ends at the
// first d that opens. Callers evaluate it only where the base draw at r
// dropped, and only in the instance of their kernel compiled for a delay
// (a template flag DELAY, chosen at launch from max_delay != 0): the
// instance without one is the kernel as it was before the delay existed.
__device__ __forceinline__ bool delayed_open(uint32_t seed, uint32_t r,
                                             uint32_t i, uint32_t j,
                                             uint32_t drop_cut,
                                             uint32_t max_delay) {
  for (uint32_t d = 1; d <= max_delay && d <= r; ++d) {
    const uint32_t q = r - d;
    if (delivery_u32(seed, q, i, j) < drop_cut &&
        delay_u32(seed, q, d, i, j) >= drop_cut)
      return true;
  }
  return false;
}

// K22 desync_skew (consensus_tpu/ops/viewsync.py:40-53; the oracle's
// cpp/oracle.cpp:968-977): the SPEC §B timer skew of node `id` (an absolute
// id, so a padded ladder lane draws what a standalone run draws) in round r:
// 0 where the activation draw (seed ^ DESYNC, r, 0, id) is not below
// desync_cut, else 1 + the depth draw (r, 1, id) mod max_skew, in
// [1, max_skew]. The depth is drawn only where the activation fires. Only
// the DESYNC instances of the kernels that take a round's timer (KQ, KT,
// KAJ) call it, picked at launch where desync_cut != 0: the instances
// without it are the kernels as they were before the skew existed.
__device__ __forceinline__ int32_t desync_skew(uint32_t seed, uint32_t r,
                                               uint32_t id,
                                               uint32_t desync_cut,
                                               uint32_t max_skew) {
  if (random_u32(seed, STREAM_DESYNC, r, 0u, id) >= desync_cut) return 0;
  return 1 + static_cast<int32_t>(
                 random_u32(seed, STREAM_DESYNC, r, 1u, id) % max_skew);
}

// K13 slot_missed (consensus_tpu/ops/adversary.py:206-213): whether round
// r's scheduled producer p misses its slot under SPEC §A.1, one draw a
// (round, producer). Cutoffs are strict u32 compares: a cutoff of 0 never
// fires, 0xFFFFFFFF (a rate of 1) fires on every draw but 0xFFFFFFFF.
__device__ __forceinline__ bool slot_missed(uint32_t seed, uint32_t r,
                                            uint32_t p, uint32_t miss_cut) {
  return random_u32(seed, STREAM_SLOTMISS, r, 0u, p) < miss_cut;
}

// K13 attack_fires (consensus_tpu/ops/adversary.py:216-219): the SPEC §A.3
// per-round activation of the targeted Raft attacks.
__device__ __forceinline__ bool attack_fires(uint32_t seed, uint32_t r,
                                             uint32_t attack_cut) {
  return random_u32(seed, STREAM_ATTACK, r, 0u, 0u) < attack_cut;
}

// K20's SPEC §A.4 draw (consensus_tpu/engines/dpos.py:157-163): whether
// producer p is suppressed in round r's window, one draw a (r / window,
// producer), so a suppressed producer misses every slot of the window.
__device__ __forceinline__ bool suppressed(uint32_t seed, uint32_t r,
                                           uint32_t window, uint32_t p,
                                           uint32_t suppress_cut) {
  return random_u32(seed, STREAM_SUPPRESS, r / window, 0u, p) < suppress_cut;
}

}  // namespace ctt
