// Kernel KE: SPEC §3 P0 churn step-down and P1 candidacy at every node of
// each sweep, plus the two per-node inputs of the election that follows.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round P0-P1
// (lines 236-253): the churn draw, step-down, candidacy with the timeout
// redrawn under the new term (engines/raft.py _draw_timeout), and the last
// log term of every node (_last_term, line 285), which P2b reads from the
// logs as they enter the round. It also writes the role == candidate mask
// that kernel KC ranks, so that mask costs no launch of its own.
//
// Bound: bytes. Per node it reads six i32 words (term, role, voted_for,
// timer, timeout, log_len) and one word of its log row, and writes five
// i32 words, the last log term and two flags: 54 bytes, 43 MB at the
// flagship shape (B = 8, N = 100 000), about 13 us at 3.35 TB/s. The
// Threefry draws (~119 integer operations each) run only for the round's
// new candidates and, once a sweep per thread, for leaders under churn.
// Design: a thread per node on a 2-D grid (node, sweep); every value stays
// in registers and the outputs are fresh buffers, so no thread reads what
// another writes. Its CRASH instance (SPEC §6c, picked when the round's
// flag word of kernel KAH is given) first resets a node recovered this
// round to a follower with its timer at 0 (raft_sparse.py:213-215), then
// writes a node down at the round's end back at that post-reset state and
// out of the candidate mask (lines 219-220, 259-260, 494-501).
// Its BYZ instance (SPEC §3c, picked with silent byzantine nodes) leaves
// their candidacies out of the mask as well: they never broadcast
// (raft_sparse.py:257-258), so KC ranks honest candidates only. An
// equivocating node's candidacy broadcasts as an honest one's does.
// Its ATTACK instances (SPEC §A.3, picked with attack "elect" or "sticky")
// write the round's attack word of each lane (atk, [B] int32, zeroed
// here first), which kernel KB's ATTACK instance and kernel KK read
// (raft_sparse.py:177-199, 236-240, 268-276, 509-514). Sticky: the target's
// own thread draws the round's activation (ctt::attack_fires) and, where
// it fires and the target led at the round's start (its role as it enters
// the round, before the §6c reset), skips the target's churn step-down and
// writes 1. Elect: each thread whose node stands in P1 and is up at the
// round's end (a down node's candidacy is a phantom the freeze reverts)
// draws the activation and, where it fires, writes 1: the lane's jam is
// the OR over a grid of many blocks, a race-free store of one value.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh; consensus_tpu/engines/raft_sparse.py:186-202 under a KnobView)
// read each lane's churn cutoff and, in an ATTACK instance, its attack
// cutoff and target from the lane's row of the table in place of the
// arguments. A lane's target is the int32 of its u32 column, as the JAX
// package's traced index (consensus_tpu/network/runner.py:1029-1031): the
// thread of the node the gather st.role[tgt] reads (a negative target
// counts from the end, then clamped to [0, N - 1]) draws the activation
// and writes the attack word, while the step-down skip compares node ids
// with the target as it is, so an out-of-range target's attack counts its
// rounds and shields no leader (and kernel KB's KNOBS instance jams no
// receiver for it).
#include <cuda_runtime.h>

#include "attack.cuh"
#include "byz.cuh"
#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int32_t ROLE_F = 0, ROLE_C = 1, ROLE_L = 2;

template <bool CRASH, bool WITHHOLD, int ATTACK, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
candidacy_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                 uint32_t churn_cut, int32_t t_min, uint32_t t_span,
                 const int32_t* __restrict__ term,
                 const int32_t* __restrict__ role,
                 const int32_t* __restrict__ voted_for,
                 const int32_t* __restrict__ timer,
                 const int32_t* __restrict__ timeout,
                 const int32_t* __restrict__ log_term,
                 const int32_t* __restrict__ log_len,
                 int32_t* __restrict__ term_out,
                 int32_t* __restrict__ role_out,
                 int32_t* __restrict__ vf_out,
                 int32_t* __restrict__ timer_out,
                 int32_t* __restrict__ timeout_out,
                 bool* __restrict__ reset_out,
                 int32_t* __restrict__ own_lterm_out,
                 bool* __restrict__ cand_out,
                 const unsigned char* __restrict__ flags, int N, int L,
                 int n_honest, uint32_t attack_cut, int tgt,
                 int32_t* __restrict__ atk,
                 const long long* __restrict__ knobs) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= N) return;
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * N + j;
  // The node whose role the sticky attack reads (tgt itself on the flat
  // path, where it is in range).
  int tread = tgt;
  if (KNOBS) {
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    if (ATTACK != ctt::ATTACK_NONE)
      attack_cut = ctt::knob(knobs, b, ctt::KNOB_ATTACK);
    if (ATTACK == ctt::ATTACK_STICKY) {
      tgt = static_cast<int32_t>(ctt::knob(knobs, b, ctt::KNOB_ATTACK_TARGET));
      tread = tgt < 0 ? tgt + N : tgt;
      tread = tread < 0 ? 0 : (tread >= N ? N - 1 : tread);
    }
  }
  const uint32_t sd = seed[b];
  int32_t tm = term[row], rl = role[row], vf = voted_for[row];
  int32_t tmr = timer[row], to = timeout[row];
  // SPEC §A.3 sticky: the target's leadership as it enters the round.
  const bool act = ATTACK == ctt::ATTACK_STICKY && j == tread &&
                   rl == ROLE_L && ctt::attack_fires(sd, r, attack_cut);
  if (act) atk[b] = 1;
  const bool sticky = act && j == tgt;
  bool down = false;
  if (CRASH) {
    const unsigned char fl = flags[row];
    if (fl & ctt::CRASH_REC) {
      rl = ROLE_F;
      tmr = 0;
    }
    down = (fl & ctt::CRASH_DOWN) != 0;
  }
  const int32_t f_tm = tm, f_rl = rl, f_vf = vf, f_tmr = tmr, f_to = to;
  bool reset = false;
  // P0: the sweep's churn event steps its leaders down.
  if (rl == ROLE_L && churn_cut != 0u && !sticky &&
      ctt::random_u32(sd, ctt::STREAM_CHURN, r, 0u, 0u) < churn_cut) {
    rl = ROLE_F;
    tmr = 0;
    reset = true;
  }
  // P1: a timed-out non-leader stands for the next term.
  if (rl != ROLE_L && tmr >= to) {
    tm = static_cast<int32_t>(static_cast<uint32_t>(tm) + 1u);
    rl = ROLE_C;
    vf = j;
    tmr = 0;
    reset = true;
    to = ctt::draw_timeout(sd, tm, j, t_min, t_span);
    if (ATTACK == ctt::ATTACK_ELECT && !(CRASH && down) &&
        ctt::attack_fires(sd, r, attack_cut))
      atk[b] = 1;
  }
  const int32_t len = log_len[row];
  const int k = min(max(len - 1, 0), L - 1);
  own_lterm_out[row] = len > 0 ? log_term[row * L + k] : 0;
  if (CRASH && down) {
    tm = f_tm, rl = f_rl, vf = f_vf, tmr = f_tmr, to = f_to;
  }
  term_out[row] = tm;
  role_out[row] = rl;
  vf_out[row] = vf;
  timer_out[row] = tmr;
  timeout_out[row] = to;
  reset_out[row] = reset;
  cand_out[row] = rl == ROLE_C && !down && !(WITHHOLD && j >= n_honest);
}

using CandidacyKernel = decltype(&candidacy_kernel<false, false, 0, false>);

template <bool CRASH, bool WITHHOLD, bool KNOBS>
CandidacyKernel candidacy_instance(int attack) {
  return attack == ctt::ATTACK_ELECT
             ? candidacy_kernel<CRASH, WITHHOLD, ctt::ATTACK_ELECT, KNOBS>
         : attack == ctt::ATTACK_STICKY
             ? candidacy_kernel<CRASH, WITHHOLD, ctt::ATTACK_STICKY, KNOBS>
             : candidacy_kernel<CRASH, WITHHOLD, ctt::ATTACK_NONE, KNOBS>;
}

template <bool KNOBS>
CandidacyKernel candidacy_pick(bool crash, bool withhold, int attack) {
  return crash ? (withhold ? candidacy_instance<true, true, KNOBS>(attack)
                           : candidacy_instance<true, false, KNOBS>(attack))
               : (withhold ? candidacy_instance<false, true, KNOBS>(attack)
                           : candidacy_instance<false, false, KNOBS>(attack));
}

}  // namespace

// attack is the SPEC §A.3 mode (0 on the flat path, where atk is null and
// attack_cut and tgt are unused); atk is the [B] attack word, zeroed here.
// knobs is a knob batch's [B, 12] table (knobs.cuh; null but in a knob
// batch): the churn, attack cutoff and target arguments are then the
// base's, which pick the instance, and each lane reads its own.
extern "C" int ctt_candidacy(const uint32_t* seed, uint32_t r,
                             uint32_t churn_cut, int32_t t_min,
                             uint32_t t_span, const int32_t* term,
                             const int32_t* role, const int32_t* voted_for,
                             const int32_t* timer, const int32_t* timeout,
                             const int32_t* log_term, const int32_t* log_len,
                             int32_t* term_out, int32_t* role_out,
                             int32_t* vf_out, int32_t* timer_out,
                             int32_t* timeout_out, bool* reset_out,
                             int32_t* own_lterm_out, bool* cand_out,
                             const unsigned char* flags, int B, int N, int L,
                             int byz, int nb, int attack, uint32_t attack_cut,
                             int tgt, int32_t* atk, const long long* knobs,
                             cudaStream_t st) {
  if (t_span == 0u || nb < 0 || nb > N || attack < ctt::ATTACK_NONE ||
      attack > ctt::ATTACK_STICKY || (attack != 0) != (atk != nullptr) ||
      (attack == ctt::ATTACK_STICKY && (tgt < 0 || tgt >= N)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  if (atk != nullptr) {
    const int err = static_cast<int>(
        cudaMemsetAsync(atk, 0, sizeof(int32_t) * B, st));
    if (err != 0) return err;
  }
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  const bool crash = flags != nullptr, withhold = byz == ctt::BYZ_SILENT;
  const auto kernel =
      knobs != nullptr ? candidacy_pick<true>(crash, withhold, attack)
                       : candidacy_pick<false>(crash, withhold, attack);
  kernel<<<grid, THREADS, 0, st>>>(
      seed, r, churn_cut, t_min, t_span, term, role, voted_for, timer,
      timeout, log_term, log_len, term_out, role_out, vf_out, timer_out,
      timeout_out, reset_out, own_lterm_out, cand_out, flags, N, L, N - nb,
      attack_cut, tgt, atk, knobs);
  return static_cast<int>(cudaGetLastError());
}
