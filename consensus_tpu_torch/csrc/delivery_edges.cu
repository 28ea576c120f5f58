// Kernel KB: the SPEC §2 delivery mask between A sender (or receiver) ids and
// all N node ids of each sweep, in one pass.
//
// Replaces: consensus_tpu/ops/adversary.py delivery_edges, with the delivery
// mixer of core/rng.py delivery_u32_jnp and the SPEC §A.2 term delayed_open
// (K13, ctt::delayed_open in rng.cuh) inside it, as engines/raft_sparse.py
// calls it four times a round: requests [A, N], responses [N, A], heartbeats
// [A, N] and acks [N, A].
//
// An edge (s, d) of round r is delivered when both ids are >= 0, s != d, the
// mixer draw fmix(absorb(absorb(absorb(seed ^ DELIVER, r), s), d)) is not
// below drop_cut or (max_delay > 0) a flight dropped on the edge in one of
// the last max_delay rounds arrives now, and, in a round whose partition is
// active (a Threefry draw below part_cut), both ends drew the same side. The
// delay term is evaluated only where the round's own draw dropped, in the
// kernels' DELAY instances, which the launch picks when max_delay > 0.
// Under SPEC §6c (the CRASH instances, picked when the round's flag word of
// kernel KAH is given) an edge with an end down at the round's end is not
// delivered (consensus_tpu/engines/raft_sparse.py:192-195).
// Under SPEC §A.3 (the ATTACK instances, picked when the round's attack word
// of kernel KE is given) an edge is not delivered where the lane's word is
// set and its receiver is atk_dst, or any receiver when atk_dst is -1: the
// sticky target's inbound edges on all four calls, every P2 edge under an
// elect jam (raft_sparse.py:197-199, 276, 338-339).
//
// Its SWITCH instances (SPEC §9, picked when kernel KAL's uplink masks and
// aggregator table are given; ids receive only) write the responses' mask of
// a switch round instead (consensus_tpu/engines/raft_sparse.py:301-334): node
// j reaches ids[a] when j != ids[a], j's uplink is open (KAL's mask, a down
// sender already cut) and its aggregator's downlink to ids[a] is open
// (ctt::agg_downlink, csrc/agg.cuh), with the crash and attack cuts above at
// the receiver. The JAX round sums up0[j] & down0[a(j), c] per candidate;
// kernel KF sums this mask, which is the same count. Their bound is bytes
// (the mask and KAL's uplinks, 7.2 MB at raft-100k): a downlink depends on
// (aggregator, candidate) only, so B*K*A draws would do, but each node's
// thread draws its aggregator's downlink to every candidate again.
//
// Bound: the [B, A, N] bool output (6.4 MB at the flagship shape) against
// ~20 integer operations an edge once the (seed, r) and per-row absorbs are
// hoisted; both are a few microseconds at 3.35 TB/s and the card's integer
// rate. Design: one thread per node id j, a 2-D grid over (j, sweep row);
// each thread hoists the absorbs it shares across its edges and writes its
// bytes so that a warp covers one contiguous span. The partition draws are
// skipped entirely when part_cut is 0, as on the flagship path.
//
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh; consensus_tpu/engines/raft_sparse.py:186-199, 301-335 under a
// KnobView) read each lane's drop cutoff (the mixer compare, the DELAY
// term, the SWITCH instance's downlinks) and partition cutoff (same_side,
// ctt::part_on) and, in an ATTACK instance under the sticky attack, its
// target from the lane's row of the table in place of the arguments. Which
// attack it is comes from the base's argument atk_dst (-1: the elect jam,
// every receiver; else the sticky attack), never from a lane's target: a
// lane's target is the int32 of its u32 column, as the JAX package's
// traced index (consensus_tpu/network/runner.py:1029-1031), and one outside
// [0, N) (0xFFFFFFFF is -1) jams no receiver, as the JAX round's compare
// dst == tgt matches no valid id.
#include <cuda_runtime.h>

#include "agg.cuh"
#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

// A lane's drop and partition cutoffs and sticky target: the arguments, or
// in a KNOBS instance the lane's row (the target under the sticky attack
// only, which the base's atk_dst >= 0 says).
struct Cuts {
  uint32_t drop, part;
  int tgt;
};

template <bool KNOBS, bool ATTACK>
__device__ __forceinline__ Cuts lane_cuts(const long long* __restrict__ knobs,
                                          int b, uint32_t drop_cut,
                                          uint32_t part_cut, int atk_dst) {
  Cuts c = {drop_cut, part_cut, atk_dst};
  if (KNOBS) {
    c.drop = ctt::knob(knobs, b, ctt::KNOB_DROP);
    c.part = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    if (ATTACK && atk_dst >= 0)
      c.tgt = static_cast<int32_t>(ctt::knob(knobs, b, ctt::KNOB_ATTACK_TARGET));
  }
  return c;
}

__device__ __forceinline__ bool same_side(uint32_t seed, uint32_t r,
                                          uint32_t part_cut, uint32_t s,
                                          uint32_t d) {
  if (part_cut == 0u) return true;
  if (ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 0u, 0u) >= part_cut)
    return true;
  const uint32_t side_s =
      ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 1u, s) & 1u;
  const uint32_t side_d =
      ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 1u, d) & 1u;
  return side_s == side_d;
}

// out[b, a, j]: ids[b, a] sends to node j. Grid (ceil(N / 256), B * A).
template <bool DELAY, bool CRASH, bool ATTACK, bool KNOBS>
__global__ void edges_src_kernel(const uint32_t* __restrict__ seed,
                                 uint32_t r, const int32_t* __restrict__ ids,
                                 unsigned char* __restrict__ out, int A,
                                 int N, uint32_t drop_cut,
                                 uint32_t part_cut, uint32_t max_delay,
                                 const unsigned char* __restrict__ flags,
                                 const int32_t* __restrict__ atk,
                                 int atk_dst,
                                 const long long* __restrict__ knobs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int row = blockIdx.y;  // b * A + a
  const int b = row / A;
  const Cuts c =
      lane_cuts<KNOBS, ATTACK>(knobs, b, drop_cut, part_cut, atk_dst);
  const int32_t id = ids[row];
  const uint32_t sd = seed[b];
  const uint32_t s = static_cast<uint32_t>(id);
  const uint32_t d = static_cast<uint32_t>(j);
  bool ok = id >= 0 && s != d;
  if (ATTACK && ok && atk[b] != 0) ok = atk_dst >= 0 && j != c.tgt;
  if (CRASH && ok)
    ok = !ctt::crash_down(flags, b, N, id) && !ctt::crash_down(flags, b, N, j);
  if (ok) {
    const uint32_t h = ctt::mix_absorb(
        ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), s);
    ok = (ctt::mix_fin(ctt::mix_absorb(h, d)) >= c.drop ||
          (DELAY && ctt::delayed_open(sd, r, s, d, c.drop, max_delay))) &&
         same_side(sd, r, c.part, s, d);
  }
  out[static_cast<long long>(row) * N + j] = ok;
}

// out[b, j, a]: node j sends to ids[b, a]. Grid (ceil(N / 256), B).
template <bool DELAY, bool CRASH, bool ATTACK, bool KNOBS>
__global__ void edges_dst_kernel(const uint32_t* __restrict__ seed,
                                 uint32_t r, const int32_t* __restrict__ ids,
                                 unsigned char* __restrict__ out, int A,
                                 int N, uint32_t drop_cut,
                                 uint32_t part_cut, uint32_t max_delay,
                                 const unsigned char* __restrict__ flags,
                                 const int32_t* __restrict__ atk,
                                 int atk_dst,
                                 const long long* __restrict__ knobs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int b = blockIdx.y;
  const Cuts c =
      lane_cuts<KNOBS, ATTACK>(knobs, b, drop_cut, part_cut, atk_dst);
  const bool jammed = ATTACK && atk[b] != 0;
  const bool src_up = !CRASH || !ctt::crash_down(flags, b, N, j);
  const uint32_t sd = seed[b];
  const uint32_t s = static_cast<uint32_t>(j);
  const uint32_t h = ctt::mix_absorb(
      ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), s);
  unsigned char* o = out + (static_cast<long long>(b) * N + j) * A;
  for (int a = 0; a < A; ++a) {
    const int32_t id = ids[b * A + a];
    const uint32_t d = static_cast<uint32_t>(id);
    o[a] = id >= 0 && s != d && src_up &&
           !(ATTACK && jammed && (atk_dst < 0 || id == c.tgt)) &&
           (!CRASH || !ctt::crash_down(flags, b, N, id)) &&
           (ctt::mix_fin(ctt::mix_absorb(h, d)) >= c.drop ||
            (DELAY &&
             ctt::delayed_open(sd, r, s, d, c.drop, max_delay))) &&
           same_side(sd, r, c.part, s, d);
  }
}

// out[b, j, a]: node j's response reaches ids[b, a] over the switch. Grid
// (ceil(N / 256), B).
template <bool DELAY, bool CRASH, bool ATTACK, bool KNOBS>
__global__ void edges_switch_kernel(const uint32_t* __restrict__ seed,
                                    uint32_t r,
                                    const int32_t* __restrict__ ids,
                                    unsigned char* __restrict__ out, int A,
                                    int N, uint32_t drop_cut,
                                    uint32_t part_cut, uint32_t max_delay,
                                    const unsigned char* __restrict__ flags,
                                    const int32_t* __restrict__ atk,
                                    int atk_dst,
                                    const bool* __restrict__ up,
                                    const int32_t* __restrict__ tab, int K,
                                    long long up_stride,
                                    const long long* __restrict__ knobs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int b = blockIdx.y;
  const Cuts c =
      lane_cuts<KNOBS, ATTACK>(knobs, b, drop_cut, part_cut, atk_dst);
  const bool jammed = ATTACK && atk[b] != 0;
  const uint32_t sd = seed[b];
  const bool sends = up[b * up_stride + j];
  const int ag = j / ctt::agg_seg(N, K);
  const int32_t word = tab[static_cast<long long>(b) * K + ag];
  const bool part = sends && ctt::part_on(sd, r, c.part);
  // Phase 0's vertex of j's aggregator, and the mixer's prefix for it.
  const uint32_t g = static_cast<uint32_t>(N) + static_cast<uint32_t>(ag);
  const uint32_t hg = ctt::downlink_prefix(sd, r, g);
  unsigned char* o = out + (static_cast<long long>(b) * N + j) * A;
  for (int a = 0; a < A; ++a) {
    const int32_t id = ids[b * A + a];
    const uint32_t d = static_cast<uint32_t>(id);
    o[a] = sends && id >= 0 && id != j &&
           !(ATTACK && jammed && (atk_dst < 0 || id == c.tgt)) &&
           (!CRASH || !ctt::crash_down(flags, b, N, id)) &&
           ctt::agg_downlink(sd, r, hg, g, d, word, c.drop,
                               DELAY ? max_delay : 0u, part,
                               part ? ctt::part_side(sd, r, d) : 0u);
  }
}

using SrcKernel = decltype(&edges_src_kernel<false, false, false, false>);
using DstKernel = decltype(&edges_dst_kernel<false, false, false, false>);
using SwitchKernel =
    decltype(&edges_switch_kernel<false, false, false, false>);

// The instance of each direction for (delay, crash, attack).
template <bool KNOBS>
SrcKernel src_instance(bool delay, bool crash, bool attack) {
  return attack
             ? (crash ? (delay ? edges_src_kernel<true, true, true, KNOBS>
                               : edges_src_kernel<false, true, true, KNOBS>)
                      : (delay ? edges_src_kernel<true, false, true, KNOBS>
                               : edges_src_kernel<false, false, true, KNOBS>))
             : (crash
                    ? (delay ? edges_src_kernel<true, true, false, KNOBS>
                             : edges_src_kernel<false, true, false, KNOBS>)
                    : (delay ? edges_src_kernel<true, false, false, KNOBS>
                             : edges_src_kernel<false, false, false, KNOBS>));
}

template <bool KNOBS>
DstKernel dst_instance(bool delay, bool crash, bool attack) {
  return attack
             ? (crash ? (delay ? edges_dst_kernel<true, true, true, KNOBS>
                               : edges_dst_kernel<false, true, true, KNOBS>)
                      : (delay ? edges_dst_kernel<true, false, true, KNOBS>
                               : edges_dst_kernel<false, false, true, KNOBS>))
             : (crash
                    ? (delay ? edges_dst_kernel<true, true, false, KNOBS>
                             : edges_dst_kernel<false, true, false, KNOBS>)
                    : (delay ? edges_dst_kernel<true, false, false, KNOBS>
                             : edges_dst_kernel<false, false, false, KNOBS>));
}

template <bool KNOBS>
SwitchKernel switch_instance(bool delay, bool crash, bool attack) {
  return delay
             ? (attack
                    ? (crash ? edges_switch_kernel<true, true, true, KNOBS>
                             : edges_switch_kernel<true, false, true, KNOBS>)
                    : (crash ? edges_switch_kernel<true, true, false, KNOBS>
                             : edges_switch_kernel<true, false, false, KNOBS>))
             : (attack
                    ? (crash ? edges_switch_kernel<false, true, true, KNOBS>
                             : edges_switch_kernel<false, false, true, KNOBS>)
                    : (crash
                           ? edges_switch_kernel<false, true, false, KNOBS>
                           : edges_switch_kernel<false, false, false, KNOBS>));
}

}  // namespace

// atk is null on the flat path (atk_dst unused), else the round's [B]
// attack word of kernel KE with the jammed receiver atk_dst (-1: all). up
// and tab are null but on a switch round: then kernel KAL's phase-0 uplink
// masks (lane stride up_stride) and [B, K] aggregator table. knobs is a knob
// batch's [B, 12] table (knobs.cuh; null but in a knob batch): the drop and
// partition cutoffs and a sticky atk_dst are then the base's, which pick
// the instance and the attack, and each lane reads its own.
extern "C" int ctt_delivery_edges(const uint32_t* seed, uint32_t r,
                                  const int32_t* ids, unsigned char* out,
                                  int B, int A, int N, uint32_t drop_cut,
                                  uint32_t part_cut, int ids_are_src,
                                  uint32_t max_delay,
                                  const unsigned char* flags,
                                  const int32_t* atk, int atk_dst,
                                  const bool* up, const int32_t* tab, int K,
                                  long long up_stride,
                                  const long long* knobs, cudaStream_t st) {
  if ((up == nullptr) != (tab == nullptr) ||
      (up != nullptr && (ids_are_src || K < 1 || K > N)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || A == 0 || N == 0) return 0;
  const int threads = 256;
  const unsigned gx = (N + threads - 1) / threads;
  const bool delay = max_delay != 0u, crash = flags != nullptr,
             attack = atk != nullptr, kn = knobs != nullptr;
  if (up != nullptr) {
    const auto kernel = kn ? switch_instance<true>(delay, crash, attack)
                           : switch_instance<false>(delay, crash, attack);
    kernel<<<dim3(gx, B), threads, 0, st>>>(
        seed, r, ids, out, A, N, drop_cut, part_cut, max_delay, flags, atk,
        atk_dst, up, tab, K, up_stride, knobs);
  } else if (ids_are_src) {
    const auto kernel = kn ? src_instance<true>(delay, crash, attack)
                           : src_instance<false>(delay, crash, attack);
    kernel<<<dim3(gx, B * A), threads, 0, st>>>(
        seed, r, ids, out, A, N, drop_cut, part_cut, max_delay, flags, atk,
        atk_dst, knobs);
  } else {
    const auto kernel = kn ? dst_instance<true>(delay, crash, attack)
                           : dst_instance<false>(delay, crash, attack);
    kernel<<<dim3(gx, B), threads, 0, st>>>(
        seed, r, ids, out, A, N, drop_cut, part_cut, max_delay, flags, atk,
        atk_dst, knobs);
  }
  return static_cast<int>(cudaGetLastError());
}
