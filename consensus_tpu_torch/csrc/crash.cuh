// The SPEC §6c crash-recover flag word that kernel KAH (crash_transition.cu)
// writes, one byte a node, and the kernels' CRASH instances read: the new
// down mask (applied in the same round), recovered this round, crashed this
// round. A node may recover and crash again in one round: both bits. The
// bits are ops/adversary.py's CRASH_DOWN, CRASH_REC and CRASH_NEW.
#pragma once

#include <cstdint>

namespace ctt {

constexpr uint32_t STREAM_CRASH = 0x68E31DA5u;

constexpr unsigned char CRASH_DOWN = 1u;
constexpr unsigned char CRASH_REC = 2u;
constexpr unsigned char CRASH_NEW = 4u;

// Whether node i of lane b is down at the round's end; false without flags
// (the flat path passes a null pointer, and only CRASH instances call this).
__device__ __forceinline__ bool crash_down(const unsigned char* flags,
                                           long long b, int N, int i) {
  return (flags[b * N + i] & CRASH_DOWN) != 0;
}

__device__ __forceinline__ bool crash_rec(const unsigned char* flags,
                                          long long b, int N, int i) {
  return (flags[b * N + i] & CRASH_REC) != 0;
}

}  // namespace ctt
