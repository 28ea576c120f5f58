// The knob table of a knob batch (engines' KNOBS instances): one row of
// u32 adversary cutoffs a lane, which the instance reads in place of its
// cutoff arguments, so that the lanes of one launch, and of one captured
// CUDA graph, run different adversary-search candidates over one static
// base config (consensus_tpu_torch/core/knobs.py, the port of
// consensus_tpu/core/knobs.py KnobView). The table is [B, KNOB_N] int64
// holding u32 values, its columns in core/knobs.py KNOB_COLUMNS order. The
// gates (which instance runs, which draws are made at all) stay the base's:
// a lane whose cutoff is 0 under a gate that is on draws and never fires.
#pragma once

#include <cstdint>

namespace ctt {

constexpr int KNOB_N = 12;

// The columns, in KNOB_COLUMNS order.
enum KnobColumn {
  KNOB_DROP = 0,
  KNOB_PARTITION = 1,
  KNOB_CHURN = 2,
  KNOB_CRASH = 3,
  KNOB_RECOVER = 4,
  KNOB_MISS = 5,
  KNOB_SUPPRESS = 6,
  KNOB_ATTACK = 7,
  KNOB_ATTACK_TARGET = 8,
  KNOB_AGG_POISON = 9,
  KNOB_BYZ_UPLINK = 10,
  KNOB_DESYNC = 11,
};

// Lane b's cutoff in column col of the table.
__device__ __forceinline__ uint32_t knob(const long long* __restrict__ knobs,
                                         long long b, int col) {
  return static_cast<uint32_t>(__ldg(knobs + b * KNOB_N + col));
}

}  // namespace ctt
