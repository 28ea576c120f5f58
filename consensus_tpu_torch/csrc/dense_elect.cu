// Kernel KM: SPEC §3 P0 churn, P1 candidacy and P2 election of the dense
// Raft round at every node of each sweep, with the winners' fresh
// replication rows.
//
// Replaces: consensus_tpu/engines/raft.py raft_round (K14) lines 301-420 on
// its flat path: the P0 churn step-down, P1 candidacy with the timeout
// redrawn under the new term (_draw_timeout, K10), P2a term catch-up (the
// highest term among the requests deliver[c, j] delivered to j), P2b
// grants (re-grant to voted_for if that candidate is eligible at j, else
// the least eligible candidate id if j has not voted), P2c the tally of
// grants delivered back on deliver[j, c], and the winners' promotion with
// their match_idx rows reset to 0 but their own log length at their own
// column and their next_idx rows to that length + 1. When the round runs
// with telemetry it also writes each node's winner flag, which the
// telemetry tail (raft.py lines 539-559, kernel KP) counts.
//
// Bound: bytes. Per node it reads six i32 words and its last log word and
// writes five i32 words and a flag (49 bytes); per (candidate, receiver)
// pair one mask byte (the request), per granting node one more (the
// response); per winner two [N] byte rows written. At raft-1kx1k (B = 8,
// N = 1024) with one candidate a sweep that is about 0.5 MB, well under a
// microsecond at 3.35 TB/s: the kernel is set by its launches' latency.
// Design: three launches on the stream.
//  1. A thread per node runs P0-P1 in registers, writes its post-P1 state
//     and its last log term, and appends itself, if a candidate, to its
//     sweep's candidate table (id, term, log length, last log term: one
//     16-byte entry; the order the atomic gives does not matter, since P2
//     takes a maximum, a minimum and a membership test over it).
//  2. A thread per receiver j walks its sweep's table once, reading the
//     request bytes deliver[c, j] (consecutive j: coalesced). It keeps the
//     highest delivered term and, among the delivered up-to-date
//     candidates of that term, the least id and whether voted_for is one
//     of them; a candidate is eligible exactly when its term is the
//     receiver's term after the catch-up, so one pass decides P2a and P2b.
//     A delivered grant is one atomic add to the candidate's tally.
//  3. A block per sweep checks its candidates (still a candidate after
//     P2a, and 1 + tally >= N / 2 + 1), promotes the winners and writes
//     their two rows with the whole block.
// The winner flags (only with telemetry: a null pointer otherwise) are
// cleared by launch 1 and set by launch 3.
// Its CRASH instances (SPEC §6c, picked when the round's flag word of kernel
// KAH is given; raft.py:267-290, 527-536): launch 1 first resets a node
// recovered this round to a follower with its timer at 0, runs P0-P1 as
// before, but writes a node down at the round's end back at its post-reset
// state. A down candidate's requests are never
// delivered (KL cut them) and its tally is 1 < N / 2 + 1 for N > 1, so it
// is listed only at N = 1, where the JAX round's in-round tally makes it a
// winner (the telemetry counts it): a down node whose frozen timer has run
// out stands again every round, and listing it would lengthen every
// receiver's walk. Launch 2 then leaves a down node as it is, since KL
// cut every request to it. Launch 3 first writes the recovered nodes' two
// rows to 0 and 1 with the whole block (the rest of their volatile reset;
// no launch reads the rows before, and a winner's rows, written after,
// win), then sets a listed down candidate's winner flag and touches
// neither its state nor its rows.
// Its BYZ instances (SPEC §3c, picked with byzantine nodes: the ids N - nb
// and up) change launch 2 only. Silent: a byzantine candidate stays listed
// but every receiver's walk skips it (its requests never travel,
// raft.py:335-337), so no grant reaches it and it wins only where 1 vote is
// a majority (N = 1), as in the JAX round; a byzantine receiver's grant
// updates its own state but never travels back (line 404). Equivocate: a
// byzantine receiver runs P2a-P2b as an honest one, then walks the table
// again and votes for every candidate c whose request it got and whose way
// back is open (deliver[c, j] & deliver[j, c], lines 405-410).
// Its ATTACK instances (SPEC §A.3, picked with attack "elect" or "sticky")
// write the round's attack word of each lane (atk, [B] int32, zeroed
// here first), which kernel KP counts (raft.py:236-253, 303-304, 320-330,
// 541-547). Sticky: in launch 1 the target's own thread draws the round's
// activation (ctt::attack_fires) and, where it fires and the target led as
// it entered the round (before the §6c reset), skips its churn step-down
// and writes 1; kernel KL's STICKY instance has already cut the target's
// inbound column. Elect: in launch 1 each thread whose node stands in P1
// and is up at the round's end draws the activation and, where it fires,
// writes 1 (the lane's jam: an OR over the grid's blocks); launch 2 then
// walks no candidate in a jammed lane, so P2a-P2c see no request and no
// response (deliver_e = deliver & ~jam), and launch 3 finds no tally.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn cutoff and, in an ATTACK instance, its
// attack cutoff and target from the lane's row of the table in place of
// the arguments (launch 1; launches 2 and 3 read no cutoff). A lane's
// target is the int32 of its u32 column, as the JAX package's traced index
// (consensus_tpu/network/runner.py:1029-1031): the thread of the node the
// gather reads (a negative target counts from the end, then clamped to
// [0, N - 1]) draws the activation and writes the attack word, while the
// step-down skip compares node ids with the target as it is, so an
// out-of-range target's attack counts its rounds and shields no leader.
// Its SWITCH instances (SPEC §9, picked when kernel KAL's uplink masks and
// aggregator table are given; raft.py:367-400) change launch 2's responses
// only: a grant (and an equivocator's vote) reaches candidate c when the
// granter j != c, j's phase-0 uplink is open (KAL's mask, a down sender
// already cut) and its aggregator's downlink to c is open
// (ctt::agg_downlink, drawn here), and, under the sticky attack, c is not
// the target while the lane's attack word is set (the JAX round zeroes the
// target's votes_in). Listed candidates are up (N > 1), so the JAX round's
// receiver fold (down0 &= up) cuts nothing here.
// Their KNOBS instances (a knob batch under the switch: raft.py:367-400
// under a KnobView) also read, in launch 2, each lane's drop and partition
// cutoffs for the downlink draws and, under the sticky attack (which the
// base's sw_tgt >= 0 says), its target for the cut on votes_in, from the
// lane's row of the table. A lane's target is the int32 of its column: one
// outside [0, N) cuts no candidate's votes, while launch 1 still writes
// the attack word from the clamped role read.
#include <climits>

#include <cuda_runtime.h>

#include "agg.cuh"
#include "attack.cuh"
#include "byz.cuh"
#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int32_t ROLE_F = 0, ROLE_C = 1, ROLE_L = 2, NONE = -1;

// A switch round's response path (SWITCH instances only).
struct Sw {
  ctt::SwitchArgs a;
  uint32_t r;
  int tgt;  // the sticky target, -1 without
};

// Launch 1. A thread per (sweep, node), flattened.
template <bool CRASH, int ATTACK, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
dense_candidacy_kernel(const uint32_t* __restrict__ seed, uint32_t r,
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
                       bool* __restrict__ win_out, int4* __restrict__ cands,
                       int* __restrict__ n_cand, int32_t* __restrict__ lterm,
                       const unsigned char* __restrict__ flags, int N, int L,
                       long long rows, uint32_t attack_cut, int tgt,
                       int32_t* __restrict__ atk,
                       const long long* __restrict__ knobs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int j = static_cast<int>(row - static_cast<long long>(b) * N);
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
  const int32_t lt = len > 0 ? log_term[row * L + k] : 0;
  if (rl == ROLE_C && !(CRASH && down && N > 1)) {
    const int q = atomicAdd(&n_cand[b], 1);
    cands[static_cast<long long>(b) * N + q] = make_int4(j, tm, len, lt);
  }
  if (CRASH && down) {
    tm = f_tm, rl = f_rl, vf = f_vf, tmr = f_tmr, to = f_to;
  }
  term_out[row] = tm;
  role_out[row] = rl;
  vf_out[row] = vf;
  timer_out[row] = tmr;
  timeout_out[row] = to;
  reset_out[row] = reset;
  if (win_out != nullptr) win_out[row] = false;
  lterm[row] = lt;
}

// Launch 2. A thread per (sweep, receiver), flattened.
template <int BYZ, bool JAM, bool SWITCH, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
dense_grants_kernel(const uint32_t* __restrict__ seed, int32_t t_min,
                    uint32_t t_span, const bool* __restrict__ deliver,
                    const int32_t* __restrict__ log_len,
                    const int4* __restrict__ cands,
                    const int* __restrict__ n_cand,
                    const int32_t* __restrict__ lterm,
                    int32_t* __restrict__ term_out,
                    int32_t* __restrict__ role_out,
                    int32_t* __restrict__ vf_out,
                    int32_t* __restrict__ timer_out,
                    int32_t* __restrict__ timeout_out,
                    bool* __restrict__ reset_out, int* __restrict__ votes,
                    int N, long long rows, int n_honest,
                    const int32_t* __restrict__ atk, Sw sw,
                    const long long* __restrict__ knobs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int j = static_cast<int>(row - static_cast<long long>(b) * N);
  const long long nodes = static_cast<long long>(b) * N;
  // The sticky cut's target: the base's (in range), or the lane's as it is.
  int cut_tgt = sw.tgt;
  if (KNOBS) {
    sw.a.drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    sw.a.part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    if (sw.tgt >= 0)
      cut_tgt =
          static_cast<int32_t>(ctt::knob(knobs, b, ctt::KNOB_ATTACK_TARGET));
  }
  // Whether j's response reaches candidate c: deliver[j, c], or over the
  // switch.
  auto back = [&](int c) -> bool {
    if (!SWITCH) return deliver[row * N + c];
    if (c == j || (sw.tgt >= 0 && atk[b] != 0 && c == cut_tgt) ||
        !sw.a.g.up[static_cast<long long>(b) * sw.a.g.phases * N + j])
      return false;
    const ctt::SwitchLane sl = ctt::switch_lane(sw.a, seed[b], sw.r, c);
    return ctt::switch_down(sw.a, sl, b, N, 0, j / sw.a.g.seg);
  };
  const int4* table = cands + nodes;
  // An elect-jammed lane: no request and no response travels.
  const int nc = JAM && atk[b] != 0 ? 0 : n_cand[b];
  int32_t tm = term_out[row], vf = vf_out[row];
  const int32_t ol = lterm[row], ll = log_len[row];
  // One pass: the highest delivered request term `top`, and over the
  // delivered up-to-date candidates of term `top`, the least id and
  // whether voted_for is among them.
  bool any = false, vf_elig = false;
  int32_t top = INT_MIN, first = N;
  for (int q = 0; q < nc; ++q) {
    const int4 c = table[q];  // id, term, log length, last log term
    if (BYZ == ctt::BYZ_SILENT && c.x >= n_honest) continue;
    if (!deliver[(nodes + c.x) * N + j]) continue;
    if (!any || c.y > top) {
      any = true;
      top = c.y;
      vf_elig = false;
      first = N;
    }
    if (c.y == top && (c.w > ol || (c.w == ol && c.z >= ll))) {
      vf_elig |= c.x == vf;
      first = min(first, c.x);
    }
  }
  // P2a: catch up to the highest delivered request term (0 when none).
  const int32_t t_in = any ? max(top, 0) : 0;
  int32_t rl = role_out[row], tmr = timer_out[row], to = timeout_out[row];
  if (t_in > tm) {
    tm = t_in;
    rl = ROLE_F;
    vf = NONE;
    to = ctt::draw_timeout(seed[b], tm, j, t_min, t_span);
  }
  // P2b: the candidates of term `top` are eligible iff that is j's term.
  if (!any || top != tm) {
    vf_elig = false;
    first = N;
  }
  const int32_t grant =
      (vf >= 0 && vf_elig) ? vf : (vf == NONE && first < N ? first : NONE);
  bool rs = reset_out[row];
  const bool honest = BYZ == ctt::BYZ_NONE || j < n_honest;
  if (grant >= 0) {
    vf = grant;
    tmr = 0;
    rs = true;
    // P2c: the grant travels back on deliver[j, grant].
    if (honest && back(grant)) atomicAdd(&votes[nodes + grant], 1);
  }
  if (BYZ == ctt::BYZ_EQUIV && !honest) {
    for (int q = 0; q < nc; ++q) {
      const int c = table[q].x;
      if (deliver[(nodes + c) * N + j] && back(c))
        atomicAdd(&votes[nodes + c], 1);
    }
  }
  term_out[row] = tm;
  role_out[row] = rl;
  vf_out[row] = vf;
  timer_out[row] = tmr;
  timeout_out[row] = to;
  reset_out[row] = rs;
}

// Launch 3. A block per sweep.
template <bool CRASH>
__global__ void __launch_bounds__(THREADS)
dense_winners_kernel(const int32_t* __restrict__ log_len,
                     const int4* __restrict__ cands,
                     const int* __restrict__ n_cand,
                     const int* __restrict__ votes,
                     int32_t* __restrict__ role_out,
                     int32_t* __restrict__ timer_out,
                     bool* __restrict__ reset_out,
                     bool* __restrict__ win_out,
                     uint8_t* __restrict__ match_idx,
                     uint8_t* __restrict__ next_idx,
                     const unsigned char* __restrict__ flags, int N) {
  __shared__ int s_n;
  __shared__ int s_won[THREADS];
  const int b = blockIdx.x;
  const long long nodes = static_cast<long long>(b) * N;
  const int nc = n_cand[b];
  const int majority = N / 2 + 1;
  if (CRASH) {
    // The recovered nodes' rows, a block-wide write each.
    for (int base = 0; base < N; base += THREADS) {  // uniform in the block
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
      const int j = base + threadIdx.x;
      if (j < N && (flags[nodes + j] & ctt::CRASH_REC))
        s_won[atomicAdd(&s_n, 1)] = j;
      __syncthreads();
      for (int q = 0; q < s_n; ++q) {
        const long long row = nodes + s_won[q];
        for (int k = threadIdx.x; k < N; k += THREADS) {
          match_idx[row * N + k] = 0;
          next_idx[row * N + k] = 1;
        }
      }
      __syncthreads();
    }
  }
  for (int base = 0; base < nc; base += THREADS) {  // uniform in the block
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    const int q = base + threadIdx.x;
    if (q < nc) {
      const int c = cands[nodes + q].x;
      const long long row = nodes + c;
      if (CRASH && (flags[row] & ctt::CRASH_DOWN)) {
        // Its in-round role is still candidate: KL cut every request.
        if (win_out != nullptr && 1 + votes[row] >= majority)
          win_out[row] = true;
      } else if (role_out[row] == ROLE_C && 1 + votes[row] >= majority) {
        role_out[row] = ROLE_L;
        timer_out[row] = 0;
        reset_out[row] = true;
        if (win_out != nullptr) win_out[row] = true;
        s_won[atomicAdd(&s_n, 1)] = c;
      }
    }
    __syncthreads();
    for (int w = 0; w < s_n; ++w) {
      const int c = s_won[w];
      const long long row = nodes + c;
      const int32_t len = log_len[row];
      uint8_t* m = match_idx + row * N;
      uint8_t* n = next_idx + row * N;
      for (int k = threadIdx.x; k < N; k += THREADS) {
        m[k] = k == c ? static_cast<uint8_t>(len) : 0;
        n[k] = static_cast<uint8_t>(len + 1);
      }
    }
    __syncthreads();
  }
}

using CandidacyKernel = decltype(&dense_candidacy_kernel<false, 0, false>);
using GrantsKernel = decltype(&dense_grants_kernel<0, false, false, false>);

template <bool CRASH, bool KNOBS>
CandidacyKernel candidacy_instance(int attack) {
  return attack == ctt::ATTACK_ELECT
             ? dense_candidacy_kernel<CRASH, ctt::ATTACK_ELECT, KNOBS>
         : attack == ctt::ATTACK_STICKY
             ? dense_candidacy_kernel<CRASH, ctt::ATTACK_STICKY, KNOBS>
             : dense_candidacy_kernel<CRASH, ctt::ATTACK_NONE, KNOBS>;
}

template <bool JAM, bool SWITCH, bool KNOBS>
GrantsKernel grants_instance(int byz) {
  return byz == ctt::BYZ_SILENT
             ? dense_grants_kernel<ctt::BYZ_SILENT, JAM, SWITCH, KNOBS>
         : byz == ctt::BYZ_EQUIV
             ? dense_grants_kernel<ctt::BYZ_EQUIV, JAM, SWITCH, KNOBS>
             : dense_grants_kernel<ctt::BYZ_NONE, JAM, SWITCH, KNOBS>;
}

// Launch 2's instance: the flat path reads no cutoff, so only a switch
// round has KNOBS instances.
GrantsKernel grants_pick(bool jam, bool sw_on, bool kn, int byz) {
  if (sw_on && kn)
    return jam ? grants_instance<true, true, true>(byz)
               : grants_instance<false, true, true>(byz);
  return jam ? (sw_on ? grants_instance<true, true, false>(byz)
                      : grants_instance<true, false, false>(byz))
             : (sw_on ? grants_instance<false, true, false>(byz)
                      : grants_instance<false, false, false>(byz));
}

}  // namespace

// attack is the SPEC §A.3 mode (0 on the flat path, where atk is null and
// attack_cut and tgt are unused); atk is the [B] attack word, zeroed here.
// up and tab are null but on a SPEC §9 switch round: then kernel KAL's
// [B, 1, N] uplink masks and [B, K] table, with the drop, partition and
// delay settings and the sticky target sw_tgt (-1 without the sticky
// attack). knobs is a knob batch's [B, 12] table (knobs.cuh; null but in a
// knob batch): the churn, attack cutoff, target, drop, partition and sw_tgt
// arguments are then the base's and each lane reads its own.
extern "C" int ctt_dense_elect(
    const uint32_t* seed, uint32_t r, uint32_t churn_cut, int32_t t_min,
    uint32_t t_span, const bool* deliver, const int32_t* term,
    const int32_t* role, const int32_t* voted_for, const int32_t* timer,
    const int32_t* timeout, const int32_t* log_term, const int32_t* log_len,
    uint8_t* match_idx, uint8_t* next_idx, int32_t* term_out,
    int32_t* role_out, int32_t* vf_out, int32_t* timer_out,
    int32_t* timeout_out, bool* reset_out, bool* win_out, int32_t* scratch,
    const unsigned char* flags, int B, int N, int L, int byz, int nb,
    int attack, uint32_t attack_cut, int tgt, int32_t* atk,
    const unsigned char* up, const int32_t* tab, int K, uint32_t drop_cut,
    uint32_t part_cut, uint32_t max_delay, int sw_tgt, const long long* knobs,
    cudaStream_t st) {
  if ((up == nullptr) != (tab == nullptr) ||
      (up != nullptr && (K < 1 || K > N)) ||
      (sw_tgt >= 0 && (atk == nullptr || sw_tgt >= N)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (t_span == 0u || nb < 0 || nb > N || byz < ctt::BYZ_NONE ||
      byz > ctt::BYZ_EQUIV || attack < ctt::ATTACK_NONE ||
      attack > ctt::ATTACK_STICKY || (attack != 0) != (atk != nullptr) ||
      (attack == ctt::ATTACK_STICKY && (tgt < 0 || tgt >= N)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long rows = static_cast<long long>(B) * N;
  // Scratch: the candidate tables [B, N] int4 first (16-byte aligned),
  // then the counts [B] and tallies [B, N] (zeroed here), then the last
  // log terms [B, N].
  int4* cands = reinterpret_cast<int4*>(scratch);
  int* n_cand = scratch + 4 * rows;
  int* votes = n_cand + B;
  int32_t* lterm = votes + rows;
  int err = static_cast<int>(
      cudaMemsetAsync(n_cand, 0, sizeof(int) * (B + rows), st));
  if (err != 0) return err;
  if (atk != nullptr &&
      (err = static_cast<int>(
           cudaMemsetAsync(atk, 0, sizeof(int32_t) * B, st))) != 0)
    return err;
  const unsigned blocks = static_cast<unsigned>((rows + THREADS - 1) / THREADS);
  const bool crash = flags != nullptr;
  const auto candidacy =
      knobs != nullptr
          ? (crash ? candidacy_instance<true, true>(attack)
                   : candidacy_instance<false, true>(attack))
          : (crash ? candidacy_instance<true, false>(attack)
                   : candidacy_instance<false, false>(attack));
  candidacy<<<blocks, THREADS, 0, st>>>(
      seed, r, churn_cut, t_min, t_span, term, role, voted_for, timer,
      timeout, log_term, log_len, term_out, role_out, vf_out, timer_out,
      timeout_out, reset_out, win_out, cands, n_cand, lterm, flags, N, L,
      rows, attack_cut, tgt, atk, knobs);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const bool jam = attack == ctt::ATTACK_ELECT, sw_on = up != nullptr;
  const auto grants = grants_pick(jam, sw_on, knobs != nullptr, byz);
  const Sw sw = {ctt::switch_args(up, tab, K, 1, N, drop_cut, part_cut,
                                  max_delay),
                 r, sw_tgt};
  grants<<<blocks, THREADS, 0, st>>>(
      seed, t_min, t_span, deliver, log_len, cands, n_cand, lterm, term_out,
      role_out, vf_out, timer_out, timeout_out, reset_out, votes, N, rows,
      N - nb, atk, sw, knobs);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const auto winners = crash ? dense_winners_kernel<true>
                             : dense_winners_kernel<false>;
  winners<<<B, THREADS, 0, st>>>(log_len, cands, n_cand, votes, role_out,
                                 timer_out, reset_out, win_out, match_idx,
                                 next_idx, flags, N);
  return static_cast<int>(cudaGetLastError());
}
