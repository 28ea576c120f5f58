// Kernel KAD: the first lane-wide step of a chained HotStuff round (SPEC
// §7b): P0's churn and partition draws, P1's highest-view gossip and P2's
// proposers, whose highest view V* it reduces for kernel KAE.
//
// Replaces: consensus_tpu/engines/hotstuff.py hotstuff_round (K18, lines
// 232-299) on its flat path. P1: the gossiper M is the lowest id among the
// nodes of the highest view vM, read off the lane's TOP word, which kernel
// KAF of the round before reduced from every node's final view (hotstuff.cuh;
// hotstuff_init and convert.py set it for a state given from outside). Node
// j != M hears it when vM >= 0 and M's row reaches j (the delivery mixer on
// absolute edge keys with the SPEC §A.2 retransmissions of the last
// max_delay rounds, lines 243-256, and the partition side where the round's
// partition is active); a node behind vM catches up to it (adv). P2: node i
// proposes when its view after P1 elects it (view mod N == i, floor modulo,
// int32 views of either sign), the round's churn event does not fire and the
// chain has room (b1_h + 1 < S: a full chain has no proposer). V* is the
// largest proposing view; only views above -1 are merged into the lane's
// VMAX word (at rest -1), so VMAX ends as the JAX round's max(where(prop,
// view, -1)).
//
// Bound: bytes. Each node reads its view (4 bytes) and writes its view after
// P1 and its catch-up flag (5 bytes): 7.2 MB at hotstuff-100k (B = 8, N =
// 100 000), 2.1 us at 3.35 TB/s; the draws are one mixer absorb and fmix a
// node (19 operations) and a few Threefry draws a block, 0.5 us at
// 33.5e12 a second. A launch's fixed cost is several microseconds, so the
// round's three launches set its time.
// Gates: on a round with a SPEC §6c or §B gate on, the views come from kernel
// KAJ (hotstuff_prologue.cu) and P1's key from the lane's KEY word, which KAJ
// built over the nodes up this round (the caller passes the word to read).
// The CRASH instance (picked where the round's flag word of kernel KAH is
// given) keeps a node down at the round's end from hearing the gossip and
// from proposing (lines 271-272 and 294); its view passes through.
// Design: a thread per (lane, node), the (lane, tile) pairs flattened into
// gridDim.x (no 65 535-block limit on lanes). Thread 0 of a block computes
// the lane's scalars once into shared memory: M and vM from TOP, the mixer
// state of M's row, the partition event and M's side (only where the
// partition cutoff is not 0: the side draws matter only where it is
// active), and whether the lane may propose at all (churn, h_next < S). A
// warp's largest proposing view is one __reduce_max_sync and one 64-bit
// atomicMax into VMAX, only in warps with a proposer. The view after P1 and
// the flags go to fresh outputs: no block reads what another block writes.
// Its BYZ instance (SPEC §7c, picked with silent byzantine nodes: the ids
// N - nb and up) keeps them from proposing (hotstuff.py:292-293); an
// equivocating byzantine node proposes as an honest one (its two variants
// are kernel KAE's), and P1's key, which KAF or KAJ took over the honest
// nodes, needs no change here.
// Its KNOBS instance (a knob batch: the table pointer is not null, knobs.cuh)
// reads its lane's drop, partition and churn cutoffs from the lane's row of
// the table in place of the arguments; nothing else moves.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "hotstuff.cuh"
#include "knobs.cuh"

namespace {

template <bool DELAY, bool CRASH, bool WITHHOLD, bool KNOBS>
__global__ void __launch_bounds__(hs::THREADS)
hotstuff_propose_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                        const int32_t* __restrict__ view,
                        const int32_t* __restrict__ b1_h,
                        long long* __restrict__ lane,
                        int32_t* __restrict__ view1, bool* __restrict__ adv,
                        const unsigned char* __restrict__ flags,
                        uint32_t drop_cut, uint32_t part_cut,
                        uint32_t churn_cut, uint32_t max_delay, int key_word,
                        int N, int S, int tiles, int n_honest,
                        const long long* __restrict__ knobs) {
  __shared__ hs::Row s_row;
  __shared__ int32_t s_vm;
  __shared__ int s_m;
  __shared__ bool s_can;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const uint32_t sd = seed[b];
  if (KNOBS) {
    drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
  }
  long long* lw = lane + static_cast<long long>(b) * hs::LANE_WORDS;
  if (threadIdx.x == 0) {
    const long long top = lw[key_word];
    s_vm = static_cast<int32_t>(top >> 32);
    s_m = N - 1 - static_cast<int>(static_cast<uint32_t>(top));
    const int m = min(max(s_m, 0), N - 1);
    s_row = hs::row_from(sd, r, static_cast<uint32_t>(m), part_cut);
    const int32_t h_next = hs::add_i32(b1_h[b], 1);
    s_can = h_next < S &&
            !(ctt::random_u32(sd, ctt::STREAM_CHURN, r, 0u, 0u) < churn_cut);
  }
  __syncthreads();
  const int i = tile * hs::THREADS + static_cast<int>(threadIdx.x);
  int32_t cand = -1;
  if (i < N) {
    const long long row = static_cast<long long>(b) * N + i;
    const int32_t v = view[row];
    const int32_t vm = s_vm;
    const bool up = !(CRASH && (flags[row] & ctt::CRASH_DOWN));
    const bool caught = up && vm >= 0 && i != s_m && v < vm &&
                        hs::row_open<DELAY>(s_row, sd, r,
                                            static_cast<uint32_t>(i), drop_cut,
                                            max_delay);
    const int32_t v1 = caught ? vm : v;
    view1[row] = v1;
    adv[row] = caught;
    if (up && s_can && hs::floor_mod(v1, N) == i && v1 > -1 &&
        !(WITHHOLD && i >= n_honest))
      cand = v1;
  }
  const int32_t top = __reduce_max_sync(hs::FULL, cand);
  if ((threadIdx.x & 31) == 0 && top > -1)
    atomicMax(lw + hs::VMAX, static_cast<long long>(top));
}

using Kernel = decltype(&hotstuff_propose_kernel<false, false, false, false>);

// The instance for (delay, crash, withhold) with or without the knob table.
template <bool KNOBS>
Kernel instance(bool delay, bool crash, bool withhold) {
  if (withhold)
    return crash ? (delay ? hotstuff_propose_kernel<true, true, true, KNOBS>
                          : hotstuff_propose_kernel<false, true, true, KNOBS>)
                 : (delay ? hotstuff_propose_kernel<true, false, true, KNOBS>
                          : hotstuff_propose_kernel<false, false, true, KNOBS>);
  return crash ? (delay ? hotstuff_propose_kernel<true, true, false, KNOBS>
                        : hotstuff_propose_kernel<false, true, false, KNOBS>)
               : (delay ? hotstuff_propose_kernel<true, false, false, KNOBS>
                        : hotstuff_propose_kernel<false, false, false, KNOBS>);
}

}  // namespace

// lane is the state's [B, 13] int64 lane words (hotstuff.cuh), VMAX at rest;
// key_word is the word P1's key is read from (TOP on a flat round, KEY on a
// gated one); flags is the round's [B, N] flag word of kernel KAH (null
// without a crash); knobs is a knob batch's [B, 12] table (knobs.cuh; null
// but in a knob batch).
extern "C" int ctt_hotstuff_propose(const uint32_t* seed, uint32_t r,
                                    const int32_t* view, const int32_t* b1_h,
                                    long long* lane, int32_t* view1,
                                    bool* adv, const unsigned char* flags,
                                    uint32_t drop_cut, uint32_t part_cut,
                                    uint32_t churn_cut, uint32_t max_delay,
                                    int key_word, int B, int N, int S,
                                    int byz, int nb, const long long* knobs,
                                    cudaStream_t st) {
  if ((key_word != hs::TOP && key_word != hs::KEY) || nb < 0 || nb > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + hs::THREADS - 1) / hs::THREADS;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool delay = max_delay != 0u, crash = flags != nullptr;
  const bool withhold = byz == ctt::BYZ_SILENT;
  const auto kernel = knobs != nullptr
                          ? instance<true>(delay, crash, withhold)
                          : instance<false>(delay, crash, withhold);
  kernel<<<static_cast<unsigned>(blocks), hs::THREADS, 0, st>>>(
      seed, r, view, b1_h, lane, view1, adv, flags, drop_cut, part_cut,
      churn_cut, max_delay, key_word, N, S, tiles, N - nb, knobs);
  return static_cast<int>(cudaGetLastError());
}
