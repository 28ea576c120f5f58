// Kernel KZ: SPEC §5 Paxos phases 3-6 of one round at every (acceptor,
// proposer) pair of each lane: each proposer's gate and value, the
// accepts, the accepted responses and decisions, the decide broadcast and
// learning.
//
// Replaces: consensus_tpu/engines/paxos.py paxos_round (K19) lines 182-250
// on its flat path (no crash, no switch). Phase 3: p proceeds when it
// proposes and n_prom[p] >= N // 2 + 1; v_chosen[p] = acc_val[best_a,
// slot_p] if best_bal > 0, else its own draw. Phase 4: at acceptor a,
// a_max[a, s] is the largest ballot (at least 0) of a proceeding proposer
// on s whose accept reached a with ballot >= new_promised[a, s]; the
// proposer holding it wins, and where a_max > 0 acc_bal, acc_val and
// promised become (a_max, its value, a_max), else they keep acc_bal, acc_val
// and new_promised. Phase 5: p decides when it proceeds and the acceptors
// it won whose responses reached it are a majority. Phase 6: node n learns
// slot s, where it has not, from the lowest-id decider on s whose decide
// reached n or that is n; learned_mask marks every slot such a decider
// reached.
//
// Bound: bytes, counting each tensor once: the mask in both orientations
// (2 bytes a pair), new_promised, acc_bal, acc_val and learned_val read
// and four int32 outputs written, learned_mask read and written (34 bytes
// a (row, slot)). At paxos-10kx10k (B = 1, N = S = 10 000) that is
// 3.6 GB, 1.1 ms at 3.35 TB/s.
// Design: launch 1, a thread per proposer: its gate and value, reading
// acc_val of another acceptor before any row is written (every output is
// a fresh tensor, so no launch overwrites what another reads). Launch 2, a
// block per acceptor row takes the row's accept maxima with shared-memory
// atomics, then the winner of each slot writes its value there (at most
// one proposer a slot holds the maximum: ballots are distinct), a warp
// ballot packs each 32 proposers' delivered accepted responses into one
// bit word, and the block writes the row's new acc_bal, acc_val and
// promised. Launch 3, a block per 256 proposers and TILE_ROWS rows counts
// the bits and merges each count with one atomicAdd ((chunk, tile, lane)
// flattened into gridDim.x, so any number of lanes launches). Launch 4 turns counts
// into decisions. Launch 5, a block per receiver row takes the lowest
// decider of each slot with shared-memory atomicMin and learns. When S
// slots do not fit in shared memory, a row block keeps its per-slot values
// in its own output rows instead, which it finishes last.
// Its SWITCH instance (SPEC §9, picked when kernel KAL's uplink masks and
// aggregator table are given; paxos.py:209-218) changes launch 2 only: an
// accepted response travels over the switch in phase 1 instead of
// deliver[a, p], when a's phase-1 uplink is open (KAL's mask, a down
// acceptor already cut) and its aggregator's downlink to p is open
// (ctt::agg_downlink, drawn only for a winning accept).
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn cutoff from the lane's row of the
// table in place of the argument (launch 1), and on a switch round
// (paxos.py:153-176 under a KnobView) its drop and partition cutoffs for
// the downlink draws (launch 2's SWITCH instance); the other launches read
// no cutoff.
#include <cuda_runtime.h>

#include "agg.cuh"
#include "knobs.cuh"
#include "paxos.cuh"

namespace {

using ctt::THREADS;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Launch 1. A thread per (lane, proposer).
template <bool KNOBS>
__global__ void __launch_bounds__(THREADS)
paxos_gate_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                  const int32_t* __restrict__ n_prom,
                  const int32_t* __restrict__ best_bal,
                  const int32_t* __restrict__ best_a,
                  const int32_t* __restrict__ acc_val,
                  int32_t* __restrict__ props, int P, uint32_t churn_cut,
                  int N, int S, long long rows,
                  const long long* __restrict__ knobs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int p = static_cast<int>(row - static_cast<long long>(b) * N);
  if (KNOBS) churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
  const ctt::Proposal pr = ctt::proposal(seed[b], r, p, P, churn_cut, N, S);
  const long long best = static_cast<long long>(b) * N + best_a[row];
  const int32_t value = best_bal[row] > 0 ? acc_val[best * S + pr.slot]
                                          : pr.v_own;
  int32_t* lane = props + static_cast<long long>(b) * 4 * N;
  lane[ctt::PROP_SLOT * N + p] = pr.slot;
  lane[ctt::PROP_BALLOT * N + p] = pr.ballot;
  lane[ctt::PROP_FLAG * N + p] = pr.is_prop && n_prom[row] >= N / 2 + 1;
  lane[ctt::PROP_VALUE * N + p] = value;
}

// Launch 2. A block per (lane, acceptor row).
template <bool SWITCH, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
paxos_accept_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                    ctt::SwitchArgs sw, const uint8_t* __restrict__ deliver,
                    const uint8_t* __restrict__ prep_del,
                    const int32_t* __restrict__ props,
                    const int32_t* __restrict__ new_promised,
                    const int32_t* __restrict__ acc_bal,
                    const int32_t* __restrict__ acc_val,
                    int32_t* __restrict__ promised2,
                    int32_t* __restrict__ acc_bal2,
                    int32_t* __restrict__ acc_val2,
                    uint32_t* __restrict__ bits, int n_prop, int N, int S,
                    int words, bool in_smem,
                    const long long* __restrict__ knobs) {
  extern __shared__ int32_t smem[];
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / N);
  if (KNOBS) {
    sw.drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    sw.part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
  }
  const int32_t* lane = props + static_cast<long long>(b) * 4 * N;
  const int32_t* slot_p = lane + ctt::PROP_SLOT * N;
  const int32_t* ballot = lane + ctt::PROP_BALLOT * N;
  const int32_t* proceed = lane + ctt::PROP_FLAG * N;
  const int32_t* chosen = lane + ctt::PROP_VALUE * N;
  const long long cell = row * S;
  // The accept maxima and the winners' values of the row's slots.
  int32_t* amax = in_smem ? smem : acc_bal2 + cell;
  int32_t* val = in_smem ? smem + S : acc_val2 + cell;
  for (int s = threadIdx.x; s < S; s += THREADS) amax[s] = 0;
  __syncthreads();
  const uint8_t* dt = prep_del + row * N;
  for (int p = threadIdx.x; p < n_prop; p += THREADS) {
    if (proceed[p] && dt[p] && ballot[p] >= new_promised[cell + slot_p[p]])
      atomicMax(amax + slot_p[p], ballot[p]);
  }
  __syncthreads();
  const uint8_t* d = deliver + row * N;
  uint32_t* row_bits = bits + row * words;
  for (int p0 = 0; p0 < words * 32; p0 += THREADS) {
    const int p = p0 + threadIdx.x;
    bool accd = false;
    if (p < n_prop && proceed[p] && dt[p]) {
      const int32_t s = slot_p[p];
      if (ballot[p] >= new_promised[cell + s] && ballot[p] == amax[s]) {
        val[s] = chosen[p];
        if (!SWITCH) {
          accd = d[p];
        } else {
          const int a = static_cast<int>(row - static_cast<long long>(b) * N);
          if (sw.g.up[(static_cast<long long>(b) * sw.g.phases + 1) * N + a]) {
            const ctt::SwitchLane sl = ctt::switch_lane(sw, seed[b], r, p);
            accd = ctt::switch_down(sw, sl, b, N, 1, a / sw.g.seg);
          }
        }
      }
    }
    const uint32_t word = __ballot_sync(FULL, accd);
    if ((threadIdx.x & 31) == 0 && (p >> 5) < words) row_bits[p >> 5] = word;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const int32_t a = amax[s];
    const bool has = a > 0;
    const int32_t v = val[s];
    acc_bal2[cell + s] = has ? a : acc_bal[cell + s];
    acc_val2[cell + s] = has ? v : acc_val[cell + s];
    promised2[cell + s] = has ? a : new_promised[cell + s];
  }
}

// Launch 3. A block per (proposer chunk, acceptor tile, lane), flattened
// in that order.
__global__ void __launch_bounds__(THREADS)
paxos_count_kernel(const uint32_t* __restrict__ bits,
                   int32_t* __restrict__ n_acc, int N, int words) {
  const ctt::TileBlock tb = ctt::tile_block(N);
  const int p = tb.p;
  if (p >= N) return;
  const int b = tb.b;
  const int a0 = tb.a0;
  const int a1 = min(a0 + ctt::TILE_ROWS, N);
  int count = 0;
  for (int a = a0; a < a1; ++a)
    count += (bits[(static_cast<long long>(b) * N + a) * words + (p >> 5)] >>
              (p & 31)) & 1u;
  if (count) atomicAdd(n_acc + static_cast<long long>(b) * N + p, count);
}

// Launch 4. A thread per (lane, proposer): proceed becomes decided.
__global__ void __launch_bounds__(THREADS)
paxos_decide_kernel(const int32_t* __restrict__ n_acc,
                    int32_t* __restrict__ props, int N, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int p = static_cast<int>(row - static_cast<long long>(b) * N);
  int32_t* flag = props + (static_cast<long long>(b) * 4 + ctt::PROP_FLAG) * N;
  flag[p] = flag[p] && n_acc[row] >= N / 2 + 1;
}

// Launch 5. A block per (lane, receiver row).
__global__ void __launch_bounds__(THREADS)
paxos_learn_kernel(const uint8_t* __restrict__ prep_del,
                   const int32_t* __restrict__ props,
                   const int32_t* __restrict__ learned_val,
                   const bool* __restrict__ learned_mask,
                   int32_t* __restrict__ learned_val2,
                   bool* __restrict__ learned_mask2, int n_prop, int N, int S,
                   bool in_smem) {
  extern __shared__ int32_t smem[];
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / N);
  const int n = static_cast<int>(row - static_cast<long long>(b) * N);
  const int32_t* lane = props + static_cast<long long>(b) * 4 * N;
  const int32_t* slot_p = lane + ctt::PROP_SLOT * N;
  const int32_t* decided = lane + ctt::PROP_FLAG * N;
  const int32_t* chosen = lane + ctt::PROP_VALUE * N;
  const long long cell = row * S;
  int32_t* pmin = in_smem ? smem : learned_val2 + cell;
  for (int s = threadIdx.x; s < S; s += THREADS) pmin[s] = N;
  __syncthreads();
  const uint8_t* dt = prep_del + row * N;
  for (int p = threadIdx.x; p < n_prop; p += THREADS) {
    if (decided[p] && (dt[p] || p == n)) atomicMin(pmin + slot_p[p], p);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const int32_t m = pmin[s];
    const bool found = m < N;
    const bool known = learned_mask[cell + s];
    learned_val2[cell + s] =
        found && !known ? chosen[m] : learned_val[cell + s];
    learned_mask2[cell + s] = known || found;
  }
}

}  // namespace

// knobs is a knob batch's [B, 12] table (knobs.cuh; null but in a knob
// batch): churn_cut, drop_cut and part_cut are then the base's and each
// lane reads its own.
extern "C" int ctt_paxos_accept_learn(
    const uint32_t* seed, uint32_t r, const uint8_t* deliver,
    const uint8_t* prep_del, const int32_t* new_promised,
    const int32_t* n_prom, const int32_t* best_bal, const int32_t* best_a,
    const int32_t* acc_bal, const int32_t* acc_val,
    const int32_t* learned_val, const bool* learned_mask, int32_t* promised2,
    int32_t* acc_bal2, int32_t* acc_val2, int32_t* learned_val2,
    bool* learned_mask2, int32_t* props, int32_t* n_acc, uint32_t* bits,
    int P, uint32_t churn_cut, int B, int N, int S, const unsigned char* up,
    const int32_t* tab, int K, uint32_t drop_cut, uint32_t part_cut,
    uint32_t max_delay, const long long* knobs, cudaStream_t st) {
  if ((up == nullptr) != (tab == nullptr) ||
      (up != nullptr && (K < 1 || K > N)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  static bool configured = false;
  if (!configured) {
    int err = static_cast<int>(cudaFuncSetAttribute(
        paxos_accept_kernel<false, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ctt::ROW_SMEM_MAX));
    if (err == 0)
      err = static_cast<int>(cudaFuncSetAttribute(
          paxos_accept_kernel<true, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, ctt::ROW_SMEM_MAX));
    if (err == 0)
      err = static_cast<int>(cudaFuncSetAttribute(
          paxos_accept_kernel<true, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, ctt::ROW_SMEM_MAX));
    if (err == 0)
      err = static_cast<int>(cudaFuncSetAttribute(
          paxos_learn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          ctt::ROW_SMEM_MAX));
    if (err != 0) return err;
    configured = true;
  }
  const long long rows = static_cast<long long>(B) * N;
  const int err = static_cast<int>(
      cudaMemsetAsync(n_acc, 0, rows * sizeof(int32_t), st));
  if (err != 0) return err;
  const int n_prop = P < N ? P : N;
  const int words = (N + 31) / 32;
  const unsigned row_blocks = static_cast<unsigned>((rows + THREADS - 1) /
                                                    THREADS);
  const auto gate =
      knobs != nullptr ? paxos_gate_kernel<true> : paxos_gate_kernel<false>;
  gate<<<row_blocks, THREADS, 0, st>>>(seed, r, n_prom, best_bal, best_a,
                                       acc_val, props, P, churn_cut, N, S,
                                       rows, knobs);
  const long long slot_bytes = static_cast<long long>(S) * sizeof(int32_t);
  const bool accept_smem = 2 * slot_bytes <= ctt::ROW_SMEM_MAX;
  // Only a switch round's accepts read a cutoff, so only they have a KNOBS
  // instance.
  const auto accept = up == nullptr      ? paxos_accept_kernel<false, false>
                      : knobs != nullptr ? paxos_accept_kernel<true, true>
                                         : paxos_accept_kernel<true, false>;
  const ctt::SwitchArgs sw =
      ctt::switch_args(up, tab, K, 2, N, drop_cut, part_cut, max_delay);
  accept<<<static_cast<unsigned>(rows), THREADS,
           accept_smem ? 2 * slot_bytes : 0, st>>>(
      seed, r, sw, deliver, prep_del, props, new_promised, acc_bal, acc_val,
      promised2, acc_bal2, acc_val2, bits, n_prop, N, S, words, accept_smem,
      knobs);
  paxos_count_kernel<<<ctt::tile_blocks(B, N), THREADS, 0, st>>>(
      bits, n_acc, N, words);
  paxos_decide_kernel<<<row_blocks, THREADS, 0, st>>>(n_acc, props, N, rows);
  const bool learn_smem = slot_bytes <= ctt::ROW_SMEM_MAX;
  paxos_learn_kernel<<<static_cast<unsigned>(rows), THREADS,
                       learn_smem ? slot_bytes : 0, st>>>(
      prep_del, props, learned_val, learned_mask, learned_val2,
      learned_mask2, n_prop, N, S, learn_smem);
  return static_cast<int>(cudaGetLastError());
}
