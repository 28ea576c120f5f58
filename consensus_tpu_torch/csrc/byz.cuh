// The SPEC §3c/§7c byzantine nodes as the kernels take them. Every C entry
// point of a kernel with BYZ instances takes the mode (core/config.py
// Config.byz: BYZ_NONE without byzantine nodes, whatever byz_mode says, so
// the flat instance runs; BYZ_SILENT; BYZ_EQUIV) and n_byzantine, nb: node
// i of a lane of n nodes (n_real on a PBFT f-ladder) is honest when
// i < n - nb. Honesty is a function of the id, fixed for a run, so no state
// carries it.
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace ctt {

constexpr int BYZ_NONE = 0;
constexpr int BYZ_SILENT = 1;
constexpr int BYZ_EQUIV = 2;

constexpr uint32_t STREAM_EQUIV = 0x94D049BBu;

// An equivocator's stance toward one receiver in round r: bit 0 of
// draw(seed ^ STREAM_EQUIV, r, src, dst) (consensus_tpu/engines/pbft.py:
// 180-183, hotstuff.py:329-332; ops/adversary.py equiv_stance_plain).
__device__ __forceinline__ bool equiv_stance(uint32_t seed, uint32_t r,
                                             uint32_t src, uint32_t dst) {
  return (random_u32(seed, STREAM_EQUIV, r, src, dst) & 1u) != 0u;
}

}  // namespace ctt
