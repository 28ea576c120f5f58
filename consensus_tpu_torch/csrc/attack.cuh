// SPEC §A.3 targeted Raft attacks as the kernels take them: the mode a
// launch passes (engines' Config.attack_mode, core/config.py ATTACK_*). The
// activation draw itself is ctt::attack_fires in rng.cuh.
#pragma once

namespace ctt {

constexpr int ATTACK_NONE = 0, ATTACK_ELECT = 1, ATTACK_STICKY = 2;

}  // namespace ctt
