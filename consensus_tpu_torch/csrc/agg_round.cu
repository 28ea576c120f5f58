// Kernel KAL: the SPEC §9 switch state of one round, for every lane: the
// [B, K] aggregator table, each aggregator's uplink round, every node's
// uplink to its aggregator in each phase, and the AGG_TELEMETRY tail.
//
// Replaces: consensus_tpu/ops/aggregate.py (K21) agg_round (lines 93-116),
// agg_counts (119-127), agg_poison (132-151), poison_count (190-201) and
// uplink_edge (280-311), as the count engines call them on a switch round
// (engines/raft_sparse.py:301-312, raft.py:373-380, paxos.py:161-169,
// 209-212, hotstuff.py:340-357). Aggregator a is alive unless
// draw(AGG, r, 0, a) < fail_cut; it serves stale state where draw(AGG, r, 1,
// a) < stale_cut at depth d = 1 + draw(AGG, r, 2, a) % max_stale, and then
// its uplink round is q = r - d where r >= d (else r); in phase ph it is
// poisoned (SPEC §9b) where a >= K - agg_byz and draw(POISON, r, 0, ph*K +
// a) < poison_cut. Its table word (csrc/agg.cuh) holds alive, the partition
// side of vertex N + a at round r, and the poison bit of each phase. Node
// i's uplink in phase ph is ctt::agg_uplink at its aggregator's q, cut where
// the node is down at the round's end (the round's flag word of kernel KAH,
// where given: the engines' `up0 &= up`). Its PBFT modes
// (engines/pbft.py:277-351, pbft_bcast.py:565-595, pbft_sweep.py:61-109):
// only the first PZ phases draw poison (PBFT's two vote phases; its decide
// gossip is not poisonable), the §6b engine's uplink is one mask for every
// phase, its broadcast key (q, i, i) with the partition against vertex
// N + a (aggregate.py:313-323), and with n_real ([B] int32) each lane's
// population is the vertex base N and segments a(i) = min(i / ceil(n_real
// / K), K - 1) (the f-ladder's traced segmentation, pbft_sweep.py:80,
// 99-109). With the run's counter totals t
// ([B, C] int32) it adds, at columns col .. col + 2, the failed aggregators,
// the live stale ones and the live poisoned serves over the phases (and
// the same into window `window` of the ring w, where given).
//
// Bound: operations. The function needs an aggregator's fault draws once
// and per (lane, phase, node) one mixer draw (with the §A.2 retransmissions
// its drop needs) and, with partitions, the node's side at q: at
// hotstuff-100k (B = 8, N = 100 000) about 1.8e7 operations, 0.55 us at
// 33.5e12 a second; the bytes (a byte a node written) are 0.8 MB, 0.24 us.
// This kernel does more: each node's thread redraws its aggregator's stale
// and depth draws and, with partitions, the activity and the aggregator's
// side at q, up to five Threefry draws a node.
// Design: a thread per (lane, phase, id) over ids below max(N, K), the
// (lane, phase, tile) triples flattened into gridDim.x. Id a < K of phase 0
// draws aggregator a's word (the poison bits of every phase) and q and
// counts it; id i < N of phase ph recomputes its aggregator's q from the
// same draws and writes its uplink. No thread reads what another writes, so
// any K from 1 to N runs without shared memory. The counters are summed by
// warp ballots and one integer atomic a warp and counter.
// Its KNOBS instance (a knob batch: the table pointer is not null,
// knobs.cuh) reads each lane's drop and partition cutoffs, and under the
// §9b poison gate (poison_cut != 0) its cutoff, from the lane's row of the
// table in place of the arguments; the fail and stale cutoffs are no
// knobs. The table word's side bit follows the base's partition gate, so
// a lane whose partition cutoff is 0 still carries it (never read there).
#include <cuda_runtime.h>

#include "agg.cuh"
#include "crash.cuh"
#include "knobs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Cuts {
  uint32_t fail, stale, max_stale, poison, drop, part, max_delay;
  int agg_byz;
};

template <bool KNOBS>
__global__ void __launch_bounds__(THREADS)
agg_round_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                 const unsigned char* __restrict__ flags,
                 int32_t* __restrict__ tab, int32_t* __restrict__ q_out,
                 bool* __restrict__ up, int32_t* __restrict__ t,
                 int32_t* __restrict__ w, int B, int N, int K, int P,
                 Cuts c, int tiles, int C, int col, int window,
                 int n_windows, int PZ, bool bcast,
                 const int32_t* __restrict__ n_real,
                 const long long* __restrict__ knobs) {
  const int lp = blockIdx.x / tiles;  // lane * P + phase
  const int tile = blockIdx.x - lp * tiles;
  const int b = lp / P;
  const int ph = lp - b * P;
  // The base's partition gate: a table word carries the side wherever
  // partitions are on, also in a knob batch's lane whose cutoff is 0 (as
  // the plain version packs it).
  const bool sides = c.part != 0u;
  if (KNOBS) {
    c.drop = ctt::knob(knobs, b, ctt::KNOB_DROP);
    c.part = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    if (c.poison != 0u) c.poison = ctt::knob(knobs, b, ctt::KNOB_AGG_POISON);
  }
  const int i = tile * THREADS + static_cast<int>(threadIdx.x);
  const uint32_t sd = seed[b];
  // The lane's vertex base and segment width.
  const int nr = n_real != nullptr ? n_real[b] : N;
  const uint32_t uN = static_cast<uint32_t>(nr), uK = static_cast<uint32_t>(K);
  bool dead = false, stale = false, poisoned = false;
  if (ph == 0 && i < K) {
    const uint32_t a = static_cast<uint32_t>(i);
    const bool alive =
        c.fail == 0u ||
        ctt::random_u32(sd, ctt::STREAM_AGG, r, 0u, a) >= c.fail;
    int32_t word = alive ? ctt::AGG_ALIVE : 0;
    if (sides) word |= ctt::part_side(sd, r, uN + a) ? ctt::AGG_SIDE : 0;
    int n_pz = 0;
    if (c.poison != 0u && i >= K - c.agg_byz) {
      for (int p = 0; p < PZ; ++p) {
        if (ctt::random_u32(sd, ctt::STREAM_POISON, r, 0u,
                            static_cast<uint32_t>(p) * uK + a) < c.poison) {
          word |= ctt::AGG_POISON0 << p;
          n_pz += alive;
        }
      }
    }
    const uint32_t q = ctt::agg_q(sd, r, a, c.stale, c.max_stale);
    const long long cell = static_cast<long long>(b) * K + i;
    tab[cell] = word;
    q_out[cell] = static_cast<int32_t>(q);
    dead = !alive;
    stale = alive && q != r;
    poisoned = n_pz != 0;
    if (n_pz == 2 && t != nullptr) {
      // A second phase's serve: the ballot below counts one a thread.
      atomicAdd(t + static_cast<long long>(b) * C + col + 2, 1);
      if (w != nullptr)
        atomicAdd(w + (static_cast<long long>(b) * n_windows + window) * C +
                      col + 2,
                  1);
    }
  }
  if (i < N) {
    const uint32_t a =
        static_cast<uint32_t>(min(i / ctt::agg_seg(nr, K), K - 1));
    const uint32_t q = ctt::agg_q(sd, r, a, c.stale, c.max_stale);
    const uint32_t ui = static_cast<uint32_t>(i);
    bool ok = bcast ? ctt::agg_uplink_bcast(sd, q, uN, a, ui, c.drop, c.part,
                                            c.max_delay)
                    : ctt::agg_uplink(sd, q, uN, uK, static_cast<uint32_t>(ph),
                                      a, ui, c.drop, c.part, c.max_delay);
    if (flags != nullptr && ctt::crash_down(flags, b, N, i)) ok = false;
    up[(static_cast<long long>(b) * P + ph) * N + i] = ok;
  }
  if (t == nullptr || ph != 0 || tile * THREADS >= K) return;
  const int n_dead = __popc(__ballot_sync(FULL, dead));
  const int n_stale = __popc(__ballot_sync(FULL, stale));
  const int n_pz = __popc(__ballot_sync(FULL, poisoned));
  if ((threadIdx.x & 31) != 0) return;
  int32_t* tb = t + static_cast<long long>(b) * C + col;
  int32_t* wb = w == nullptr
                    ? nullptr
                    : w + (static_cast<long long>(b) * n_windows + window) *
                                  C + col;
  const int n[3] = {n_dead, n_stale, n_pz};
  for (int k = 0; k < 3; ++k) {
    if (!n[k]) continue;
    atomicAdd(tb + k, n[k]);
    if (wb != nullptr) atomicAdd(wb + k, n[k]);
  }
}

}  // namespace

// flags is the round's [B, N] flag word of kernel KAH (null without a
// crash). tab and q are [B, K] int32 outputs, up [B, P, N] bool. t ([B, C])
// and w ([B, n_windows, C]) are the run's counter totals and window ring
// (null without telemetry; w null without the recorder). poison_cut is 0
// with the §9b knob off. PZ (<= 2) is the count of poisonable phases, bcast
// picks the §6b uplink (P = 1), n_real is null but on a PBFT round. knobs is
// a knob batch's [B, 12] table (knobs.cuh; null but in a knob batch).
extern "C" int ctt_agg_round(const uint32_t* seed, uint32_t r,
                             const unsigned char* flags, int32_t* tab,
                             int32_t* q, bool* up, int32_t* t, int32_t* w,
                             int B, int N, int K, int P, uint32_t fail_cut,
                             uint32_t stale_cut, uint32_t max_stale,
                             uint32_t poison_cut, int agg_byz,
                             uint32_t drop_cut, uint32_t part_cut,
                             uint32_t max_delay, int C, int col, int window,
                             int n_windows, int PZ, int bcast,
                             const int32_t* n_real, const long long* knobs,
                             cudaStream_t st) {
  if (K < 1 || K > N || P < 1 || P > 3 || PZ < 0 || PZ > 2 ||
      (bcast != 0 && P != 1) || max_stale < 1u ||
      agg_byz < 0 || agg_byz > K ||
      (t != nullptr && (col < 0 || col > C - 3)) ||
      (w != nullptr && (window < 0 || window >= n_windows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + THREADS - 1) / THREADS;  // K <= N
  const long long blocks = static_cast<long long>(tiles) * B * P;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const Cuts c = {fail_cut, stale_cut, max_stale, poison_cut,
                  drop_cut, part_cut, max_delay, agg_byz};
  const auto kernel =
      knobs != nullptr ? agg_round_kernel<true> : agg_round_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      seed, r, flags, tab, q, up, t, w, B, N, K, P, c, tiles, C, col, window,
      n_windows, PZ, bcast != 0, n_real, knobs);
  return static_cast<int>(cudaGetLastError());
}
