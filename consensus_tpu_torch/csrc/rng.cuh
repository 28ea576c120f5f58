// Counter-based RNG of the simulator as __device__ functions, shared by the
// kernels of this directory: Threefry-2x32 with 20 rounds (the JAX package's
// consensus_tpu/core/rng.py threefry2x32_jnp / random_u32_jnp) and the
// SPEC §2 murmur-style delivery mixer (mix_absorb_jnp / mix_fin_jnp /
// delivery_u32_jnp). All arithmetic is uint32 and wraps, which is the whole
// contract: the draws equal the JAX package's bit for bit.
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

}  // namespace ctt
