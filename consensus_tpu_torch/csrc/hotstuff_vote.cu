// Kernel KAE: the second and third lane-wide steps of a chained HotStuff
// round (SPEC §7b): the proposal's delivery, the vote count at the leader,
// and, in each lane's last block, the QC, the chain shift and the 3-chain
// commit.
//
// Replaces: consensus_tpu/engines/hotstuff.py hotstuff_round (K18, lines
// 300-433) on its flat path. V* is the lane's VMAX word, which kernel KAD
// reduced; with V* >= 0 its leader is L = V* mod N, else L = 0 and nothing is
// delivered. Node j receives the proposal (pdel) when j == L or L's row
// reaches j (the same mixer words as P1's gossip row when M == L, delayed
// retransmissions included), and its view after P1 is not above V*. Its vote
// reaches L when j == L or the mixer's draw of the REVERSE edge (j, L) is
// not below drop_cut, or (max_delay > 0) a vote lost on (j, L) in one of the
// last max_delay rounds arrives now (SPEC §A.2, lines 303-309: K13
// delayed_open as ctt::delayed_open, drawn only where the round's own draw
// dropped; given pdel the partition test of that edge is the same
// predicate, so it is not drawn). The QC forms when the lane's delivered
// votes reach Q = 2f + 1. Then b1 <- (V*, h_next), b2 <- old b1, b3 <- old
// b2, chain_v[h_next] <- V*, and where the NEW b3, b2, b1 sit in consecutive
// views the global commit becomes max(old gcommit, new b3_h + 1) (lines
// 423-433).
// Old against new: the registers are written to fresh outputs, so kernel
// KAF still reads the OLD gcommit that P6 grows the prefixes to (line 464).
//
// Bound: bytes. Each node reads its view after P1 (4 bytes) and writes its
// delivery flag (1 byte): 4 MB at hotstuff-100k (B = 8, N = 100 000), 1.2
// us at 3.35 TB/s; the draws are two mixer absorbs and fmixes a node (about
// 38 operations), 0.9 us at 33.5e12 a second. The launch's fixed cost sets
// its time.
// Design: a thread per (lane, node), the (lane, tile) pairs flattened into
// gridDim.x. Thread 0 of a block computes the lane's V*, L, L's row and the
// mixer state of the reverse edges' prefix once into shared memory. The
// votes are counted by a ballot a warp, a shared atomic a warp and one
// global 64-bit atomicAdd a block into the lane's VOTES word; then the
// block counts itself done in DONE_VOTE (KAA's last-block-done pattern,
// pbft_telemetry.cu). The lane's last block reads the count, forms the QC,
// writes the registers, chain_v[h_next] (in place: no other block of the
// round reads chain_v) and the round's V* and count for KAF, and leaves
// VMAX, VOTES and DONE_VOTE at rest and TOP empty for KAF's reduction: every
// other block of the lane has read VMAX before it counted itself done. It
// also leaves the KEY word at rest, which KAD read on a gated round.
// The CRASH instance (picked where the round's flag word of kernel KAH is
// given) delivers nothing to a node down at the round's end (line 312), so
// it neither learns nor votes; the leader proposed, so it is up.
// Its BYZ instances (SPEC §3c/§7c, picked with byzantine nodes: the ids
// N - nb and up) count honest voters only, in both modes (line 326). The
// equivocate instances (lines 327-421) draw, where the leader L is
// byzantine, the variant it shows each receiver (ctt::equiv_stance(r, L,
// j); an honest leader shows variant 0): an honest receiver votes for its
// variant, a byzantine one for both, and the votes are counted by two
// ballots a warp into VOTES and VOTES1. The lane's last block forms a QC
// where either count reaches Q (variant 0 is canonical where both do: a
// forked QC), writes chain_vid[h_next] with the certified variant, and on
// a forked QC the next free row of the fork table (ftab_v, ftab_h, fnum,
// in place; lines 436-453); it leaves the QC and the fork in QCF and the
// fork bit the deceived nodes take in FBIT for KAF, both counts' sum in
// COUNTED, and VOTES1 at rest. Each receiver also writes whether it is
// deceived: honest, delivered, shown variant 1.
// Its SWITCH instances (SPEC §9, picked when kernel KAL's uplink masks and
// aggregator table are given; lines 340-392) count the votes over the switch
// instead of the reverse edges: a supporter j != L counts where its phase-0
// uplink is open (KAL's mask, a down node already cut) and its aggregator's
// downlink to L is open (ctt::agg_downlink, drawn a thread), and L counts its
// own support locally. SPEC §9b: an aggregator poisoned in phase 0 (its table
// bit) whose downlink to L is open counts one for each member of its
// segment, the leader included, whose local support then drops; a
// byzantine node's uplink lie (ctt::uplink_lie, where uplink_cut != 0) is a
// claimed vote that needs no proposal, and under equivocation it counts,
// like a byzantine receiver's vote, for both variants. Summed per sender
// this is the JAX round's self vote plus its delivered segment sums, so the
// ballots, the QC, the fork table and the counts above stay as they are;
// the count runs whether or not a proposal exists (poisoned serves and lies
// count either way, as the JAX round's telemetry counts them).
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's drop and partition cutoffs, and under the
// §9b lies' gate (uplink_cut != 0) their cutoff, from the lane's row of the
// table in place of the arguments, the switch's downlink draws included.
#include <cuda_runtime.h>

#include "agg.cuh"
#include "byz.cuh"
#include "crash.cuh"
#include "hotstuff.cuh"
#include "knobs.cuh"

namespace {

// The registers, in their order in the inputs and the [7, B] output.
enum { B1_V, B1_H, B2_V, B2_H, B3_V, B3_H, GCOMMIT, REGS };

struct Regs {
  const int32_t* in[REGS];
};

// The fork-table leaves the equivocate instances update, in place.
struct Fork {
  int32_t* chain_vid;  // [B, S]
  int32_t* ftab_v;     // [B, FORK_TABLE]
  int32_t* ftab_h;     // [B, FORK_TABLE]
  int32_t* fnum;       // [B]
  bool* deceived;      // [B, N] output
};

constexpr int FORK_TABLE = 8;

// A switch round's vote path (SWITCH instances only).
struct Sw {
  ctt::SwitchArgs a;
  uint32_t uplink_cut;  // §9b lies, 0 without
};

template <bool DELAY, bool CRASH, int BYZ, bool SWITCH, bool KNOBS>
__global__ void __launch_bounds__(hs::THREADS)
hotstuff_vote_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                     const int32_t* __restrict__ view1,
                     long long* __restrict__ lane, Regs regs,
                     int32_t* __restrict__ chain_v, bool* __restrict__ pdel,
                     int32_t* __restrict__ regs_out,
                     const unsigned char* __restrict__ flags,
                     uint32_t drop_cut,
                     uint32_t part_cut, uint32_t max_delay, int Q, int B,
                     int N, int S, int tiles, int n_honest, Fork fork,
                     Sw sw, const long long* __restrict__ knobs) {
  constexpr bool EQUIV = BYZ == ctt::BYZ_EQUIV;
  __shared__ ctt::SwitchLane s_sl;
  __shared__ hs::Row s_row;
  __shared__ uint32_t s_h0;
  __shared__ int32_t s_vstar;
  __shared__ int s_l;
  __shared__ bool s_byzl;
  __shared__ int s_votes, s_votes1;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const uint32_t sd = seed[b];
  if (KNOBS) {
    drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    if (SWITCH) {
      sw.a.drop_cut = drop_cut;
      sw.a.part_cut = part_cut;
      if (sw.uplink_cut != 0u)
        sw.uplink_cut = ctt::knob(knobs, b, ctt::KNOB_BYZ_UPLINK);
    }
  }
  long long* lw = lane + static_cast<long long>(b) * hs::LANE_WORDS;
  if (threadIdx.x == 0) {
    const int32_t vstar = static_cast<int32_t>(lw[hs::VMAX]);
    s_vstar = vstar;
    s_l = vstar >= 0 ? vstar % N : 0;
    s_row = hs::row_from(sd, r, static_cast<uint32_t>(s_l), part_cut);
    s_h0 = ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r);
    s_byzl = EQUIV && vstar >= 0 && s_l >= n_honest;
    s_votes = 0;
    s_votes1 = 0;
    if (SWITCH) s_sl = ctt::switch_lane(sw.a, sd, r, s_l);
  }
  __syncthreads();
  const int i = tile * hs::THREADS + static_cast<int>(threadIdx.x);
  bool voted = false, voted1 = false;
  if (i < N) {
    const long long row = static_cast<long long>(b) * N + i;
    const int32_t vstar = s_vstar;
    const bool is_l = i == s_l;
    const bool got =
        vstar >= 0 && view1[row] <= vstar &&
        !(CRASH && (flags[row] & ctt::CRASH_DOWN)) &&
        (is_l || hs::row_open<DELAY>(s_row, sd, r, static_cast<uint32_t>(i),
                                     drop_cut, max_delay));
    pdel[row] = got;
    if (SWITCH) {
      // The two-hop of this sender, a poisoned serve of its segment, its
      // lie, and its support: vote (honest receivers), claim (a byzantine
      // receiver's vote under equivocation, or a lie).
      const int ag = i / sw.a.g.seg;
      const bool down = ctt::switch_down(sw.a, s_sl, b, N, 0, ag);
      const bool pzd =
          down && (sw.a.g.tab[static_cast<long long>(b) * sw.a.g.K + ag] &
                   ctt::AGG_POISON0);
      const bool honest = BYZ == ctt::BYZ_NONE || i < n_honest;
      const bool lie = !honest && sw.uplink_cut != 0u &&
                       ctt::uplink_lie(sd, r, static_cast<uint32_t>(i),
                                       sw.uplink_cut);
      const bool up0 =
          sw.a.g.up[static_cast<long long>(b) * sw.a.g.phases * N + i];
      const bool vote = got && honest;
      const bool ev =
          EQUIV && s_byzl && got &&
          ctt::equiv_stance(sd, r, static_cast<uint32_t>(s_l),
                            static_cast<uint32_t>(i));
      const bool claim = (EQUIV && got && !honest) || lie;
      const bool sup0 = EQUIV ? (vote && !ev) || claim : vote || lie;
      const bool sup1 = (vote && ev) || claim;
      // L's local support: its vote, or under equivocation its support.
      const bool self0 = EQUIV ? sup0 : vote;
      voted = pzd || (is_l ? self0 : sup0 && up0 && down);
      voted1 = EQUIV && (pzd || (is_l ? sup1 : sup1 && up0 && down));
      if (EQUIV) fork.deceived[row] = got && honest && ev;
    } else {
    voted = got && (is_l ||
                    ctt::mix_fin(ctt::mix_absorb(
                        ctt::mix_absorb(s_h0, static_cast<uint32_t>(i)),
                        static_cast<uint32_t>(s_l))) >= drop_cut ||
                    (DELAY &&
                     ctt::delayed_open(sd, r, static_cast<uint32_t>(i),
                                       static_cast<uint32_t>(s_l), drop_cut,
                                       max_delay)));
    if (BYZ != ctt::BYZ_NONE) {
      const bool honest = i < n_honest;
      if (EQUIV) {
        // The variant this receiver was shown, and its votes for each.
        const bool ev = s_byzl && got &&
                        ctt::equiv_stance(sd, r, static_cast<uint32_t>(s_l),
                                          static_cast<uint32_t>(i));
        voted1 = voted && (!honest || ev);
        fork.deceived[row] = got && honest && ev;
        voted = voted && (!honest || !ev);
      } else {
        voted = voted && honest;
      }
    }
    }
  }
  const int warp_votes = __popc(__ballot_sync(hs::FULL, voted));
  if ((threadIdx.x & 31) == 0 && warp_votes) atomicAdd(&s_votes, warp_votes);
  if (EQUIV) {
    const int warp_votes1 = __popc(__ballot_sync(hs::FULL, voted1));
    if ((threadIdx.x & 31) == 0 && warp_votes1)
      atomicAdd(&s_votes1, warp_votes1);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long* uw = reinterpret_cast<unsigned long long*>(lw);
  if (s_votes)
    atomicAdd(uw + hs::VOTES, static_cast<unsigned long long>(s_votes));
  if (EQUIV && s_votes1)
    atomicAdd(uw + hs::VOTES1, static_cast<unsigned long long>(s_votes1));
  __threadfence();
  if (atomicAdd(uw + hs::DONE_VOTE, 1ull) !=
      static_cast<unsigned long long>(tiles - 1))
    return;
  __threadfence();
  // The lane's last block: P3's QC and P4.
  const long long votes0 =
      static_cast<long long>(atomicAdd(uw + hs::VOTES, 0ull));
  const long long votes1 =
      EQUIV ? static_cast<long long>(atomicAdd(uw + hs::VOTES1, 0ull)) : 0;
  const long long votes = votes0 + votes1;
  const int32_t vstar = s_vstar;
  const bool qc0 = vstar >= 0 && votes0 >= Q;
  const bool qc1 = EQUIV && vstar >= 0 && votes1 >= Q;
  const bool qc = qc0 || qc1;
  int32_t reg[REGS];
  for (int k = 0; k < REGS; ++k) reg[k] = regs.in[k][b];
  const int32_t h_next = hs::add_i32(reg[B1_H], 1);
  if (qc) {
    reg[B3_V] = reg[B2_V];
    reg[B3_H] = reg[B2_H];
    reg[B2_V] = reg[B1_V];
    reg[B2_H] = reg[B1_H];
    reg[B1_V] = vstar;
    reg[B1_H] = h_next;
    if (h_next >= 0 && h_next < S) {
      chain_v[static_cast<long long>(b) * S + h_next] = vstar;
      if (EQUIV)
        fork.chain_vid[static_cast<long long>(b) * S + h_next] = qc0 ? 0 : 1;
    }
    const bool consec = reg[B3_V] >= 0 &&
                        reg[B1_V] == hs::add_i32(reg[B2_V], 1) &&
                        reg[B2_V] == hs::add_i32(reg[B3_V], 1);
    if (consec) reg[GCOMMIT] = max(reg[GCOMMIT], hs::add_i32(reg[B3_H], 1));
  }
  for (int k = 0; k < REGS; ++k)
    regs_out[static_cast<long long>(k) * B + b] = reg[k];
  if (EQUIV) {
    // A forked QC takes the fork table's next free row.
    const bool forked = qc0 && qc1;
    const int32_t fn = fork.fnum[b];
    const bool can = forked && fn < FORK_TABLE;
    if (can) {
      fork.ftab_v[static_cast<long long>(b) * FORK_TABLE + fn] = vstar;
      fork.ftab_h[static_cast<long long>(b) * FORK_TABLE + fn] = h_next;
      fork.fnum[b] = fn + 1;
    }
    lw[hs::QCF] = static_cast<long long>(qc) | (forked ? 2ll : 0ll);
    lw[hs::FBIT] = can ? 1ll << min(max(fn, 0), FORK_TABLE - 1) : 0ll;
    lw[hs::VOTES1] = 0;
  }
  lw[hs::VSTAR] = vstar;
  lw[hs::COUNTED] = votes;
  lw[hs::VMAX] = -1;
  lw[hs::VOTES] = 0;
  lw[hs::DONE_VOTE] = 0;
  lw[hs::TOP] = hs::I64_MIN;
  lw[hs::KEY] = hs::KEY_REST;
}

using Kernel =
    decltype(&hotstuff_vote_kernel<false, false, 0, false, false>);

// The instance for (delay, crash, byz) with or without the switch and the
// knob table.
template <bool SWITCH, bool KNOBS>
Kernel instance(bool delay, bool crash, int byz) {
  if (byz == ctt::BYZ_SILENT)
    return crash ? (delay ? hotstuff_vote_kernel<true, true, 1, SWITCH, KNOBS>
                          : hotstuff_vote_kernel<false, true, 1, SWITCH, KNOBS>)
                 : (delay ? hotstuff_vote_kernel<true, false, 1, SWITCH, KNOBS>
                          : hotstuff_vote_kernel<false, false, 1, SWITCH,
                                                 KNOBS>);
  if (byz == ctt::BYZ_EQUIV)
    return crash ? (delay ? hotstuff_vote_kernel<true, true, 2, SWITCH, KNOBS>
                          : hotstuff_vote_kernel<false, true, 2, SWITCH, KNOBS>)
                 : (delay ? hotstuff_vote_kernel<true, false, 2, SWITCH, KNOBS>
                          : hotstuff_vote_kernel<false, false, 2, SWITCH,
                                                 KNOBS>);
  return crash ? (delay ? hotstuff_vote_kernel<true, true, 0, SWITCH, KNOBS>
                        : hotstuff_vote_kernel<false, true, 0, SWITCH, KNOBS>)
               : (delay ? hotstuff_vote_kernel<true, false, 0, SWITCH, KNOBS>
                        : hotstuff_vote_kernel<false, false, 0, SWITCH, KNOBS>);
}

}  // namespace

// regs are the seven [B] int32 registers at round entry (b1_v, b1_h, b2_v,
// b2_h, b3_v, b3_h, gcommit), regs_out their [7, B] values after P4. lane is
// the state's [B, 13] int64 lane words (hotstuff.cuh): VOTES, VOTES1 and
// DONE_VOTE at rest. flags is the round's [B, N] flag word of kernel KAH
// (null without a crash). chain_vid ([B, S]), ftab_v, ftab_h ([B, 8]), fnum
// ([B]) and deceived ([B, N] bool output) are given exactly with byz =
// BYZ_EQUIV. up and tab are null but on a SPEC §9 switch round: then kernel
// KAL's [B, 1, N] uplink masks and [B, K] table (the downlinks are drawn with
// drop_cut, part_cut and max_delay), and uplink_cut the §9b lies' cutoff (0:
// none). knobs is a knob batch's [B, 12] table (knobs.cuh; null but in a
// knob batch).
extern "C" int ctt_hotstuff_vote(
    const uint32_t* seed, uint32_t r, const int32_t* view1, long long* lane,
    const int32_t* b1_v, const int32_t* b1_h, const int32_t* b2_v,
    const int32_t* b2_h, const int32_t* b3_v, const int32_t* b3_h,
    const int32_t* gcommit, int32_t* chain_v, bool* pdel, int32_t* regs_out,
    const unsigned char* flags, uint32_t drop_cut, uint32_t part_cut,
    uint32_t max_delay, int Q, int B, int N, int S, int byz, int nb,
    int32_t* chain_vid, int32_t* ftab_v, int32_t* ftab_h, int32_t* fnum,
    bool* deceived, const unsigned char* up, const int32_t* tab, int K,
    uint32_t uplink_cut, const long long* knobs, cudaStream_t st) {
  const bool equiv = byz == ctt::BYZ_EQUIV;
  if ((up == nullptr) != (tab == nullptr) ||
      (up != nullptr && (K < 1 || K > N)) ||
      (up == nullptr && uplink_cut != 0u))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb < 0 || nb > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV ||
      equiv != (chain_vid != nullptr) || equiv != (ftab_v != nullptr) ||
      equiv != (ftab_h != nullptr) || equiv != (fnum != nullptr) ||
      equiv != (deceived != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + hs::THREADS - 1) / hs::THREADS;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  Regs regs = {{b1_v, b1_h, b2_v, b2_h, b3_v, b3_h, gcommit}};
  const Fork fork = {chain_vid, ftab_v, ftab_h, fnum, deceived};
  const bool delay = max_delay != 0u, crash = flags != nullptr;
  const bool sw_on = up != nullptr, kn = knobs != nullptr;
  const auto kernel =
      sw_on ? (kn ? instance<true, true>(delay, crash, byz)
                  : instance<true, false>(delay, crash, byz))
            : (kn ? instance<false, true>(delay, crash, byz)
                  : instance<false, false>(delay, crash, byz));
  const Sw sw = {ctt::switch_args(up, tab, K, 1, N, drop_cut, part_cut,
                                  max_delay),
                 uplink_cut};
  kernel<<<static_cast<unsigned>(blocks), hs::THREADS, 0, st>>>(
      seed, r, view1, lane, regs, chain_v, pdel, regs_out, flags, drop_cut,
      part_cut, max_delay, Q, B, N, S, tiles, N - nb, fork, sw, knobs);
  return static_cast<int>(cudaGetLastError());
}
