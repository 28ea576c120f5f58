// Kernel KY: SPEC §5 Paxos phases 1-2 of one round at every (acceptor,
// proposer) pair of each lane: the prepares' per-slot maximum at each
// acceptor, the promises, their count and the highest accepted ballot they
// carry.
//
// Replaces: consensus_tpu/engines/paxos.py paxos_round (K19) lines 93-180 on
// its flat path (no crash, no switch). prep_del[a, p] = deliver[p, a] and
// resp_del[a, p] = deliver[a, p]. Phase 1: new_promised[a, s] =
// max(promised[a, s], the largest ballot, at least 0, of a proposer on slot
// s whose prepare reached a). Phase 2: a promises p when p proposes, both
// flights are delivered, p's ballot > promised[a, slot_p] and == new_
// promised[a, slot_p]; n_prom[p] counts them; best_bal[p] = max over every
// acceptor of (its acc_bal[a, slot_p] where it promised, else 0), and
// best_a[p] the lowest acceptor holding it (jnp.argmax's first maximum).
//
// Bound: bytes, counting each tensor once: the mask read and its
// transpose written (2 bytes a pair), promised and acc_bal read and
// new_promised written (12 bytes a (row, slot)), and the per-proposer
// outputs (12 bytes a proposer). At paxos-10kx10k (B = 1, N = S = 10 000)
// that is 2e8 + 1.2e9 bytes, 1.4 GB, 0.418 ms at 3.35 TB/s. This kernel's
// phase-2 tiles also gather promised, new_promised and acc_bal at each
// proposer's slot, one 32-byte sector a pair that L2 serves, which is
// not counted (PERF.md §6).
// Design: launch 1, a thread per proposer draws its slot and ballot once
// into scratch. Launch 2 writes the mask's transpose through 32 x 32 tiles
// in shared memory, so that every later read of either orientation is a
// row read. Launch 3, a block per acceptor row takes the row's per-slot
// prepare maxima with shared-memory atomics (in the output row itself when
// S slots do not fit in shared memory) and writes new_promised. Launch 4,
// a block per 256 proposers and TILE_ROWS acceptors: each thread walks its
// proposer down the tile's rows, counts promises and keeps the best
// (acc_bal, -a) as one 64-bit key, then merges both with one atomicAdd and
// one atomicMax per tile (the packed key gives the lowest acceptor among
// equal ballots in any order). Launch 5 unpacks the keys. Launches 2 and 4
// put (tile, lane) into gridDim.x, so any number of lanes launches. Where
// the caller passes n_pair ([B, N] int32, zeroed here; the telemetry's
// nacks are n_pair - n_prom), launch 4 also counts, for each proposing p,
// the acceptors with both of p's flights delivered (prep_del[a, p] and
// deliver[a, p], the mask's diagonal as KL gives it), merged like n_prom.
// Its CRASH instances (SPEC §6c, picked when the round's flag word of kernel
// KAH is given) read the promised row of an acceptor recovered this round
// as 0 in launches 3 and 4 (its volatile reset, paxos.py:118-122); KL has
// already cut every flight of a down node.
// Its SWITCH instances (SPEC §9, picked when kernel KAL's uplink masks and
// aggregator table are given; paxos.py:153-176) change launch 4 only: a
// promise travels back over the switch instead of deliver[a, p], when a's
// phase-0 uplink is open (KAL's mask, a down acceptor already cut) and its
// aggregator's downlink to p is open (ctt::agg_downlink, drawn here once a
// thread for each segment its tile crosses); n_pair then counts the
// promises and, beside them, the acceptors with both flat flights
// delivered that did not promise (the nacks, paxos.py:256, still read the
// flat mask).
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn cutoff from the lane's row of the
// table in place of the argument (launch 1), and on a switch round
// (paxos.py:153-176 under a KnobView) its drop and partition cutoffs for
// the downlink draws (launch 4's SWITCH instances); the other launches
// read no cutoff.
#include <cuda_runtime.h>

#include "agg.cuh"
#include "crash.cuh"
#include "knobs.cuh"
#include "paxos.cuh"

namespace {

using ctt::THREADS;

__device__ __forceinline__ unsigned long long pack(int32_t bal, int a) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(bal) ^
                                          0x80000000u)
          << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu -
                                         static_cast<uint32_t>(a));
}

// Launch 1. A thread per (lane, proposer).
template <bool KNOBS>
__global__ void __launch_bounds__(THREADS)
paxos_propose_kernel(const uint32_t* __restrict__ seed, uint32_t r,
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
  int32_t* lane = props + static_cast<long long>(b) * 4 * N;
  lane[ctt::PROP_SLOT * N + p] = pr.slot;
  lane[ctt::PROP_BALLOT * N + p] = pr.ballot;
  lane[ctt::PROP_FLAG * N + p] = pr.is_prop;
  lane[ctt::PROP_VALUE * N + p] = pr.v_own;
}

// Launch 2. A block of 32 x 8 per (column tile, row tile, lane), flattened
// in that order.
__global__ void paxos_transpose_kernel(const uint8_t* __restrict__ in,
                                       uint8_t* __restrict__ out, int N,
                                       int tiles) {
  __shared__ uint8_t tile[32][33];
  const long long t = blockIdx.x / tiles;
  const int tx = static_cast<int>(blockIdx.x - t * tiles);
  const long long b = t / tiles;
  const int ty = static_cast<int>(t - b * tiles);
  const long long base = b * N * N;
  const int x = tx * 32 + threadIdx.x;
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int y = ty * 32 + k;
    if (x < N && y < N)
      tile[k][threadIdx.x] = in[base + static_cast<long long>(y) * N + x];
  }
  __syncthreads();
  const int ox = ty * 32 + threadIdx.x;
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int oy = tx * 32 + k;
    if (ox < N && oy < N)
      out[base + static_cast<long long>(oy) * N + ox] = tile[threadIdx.x][k];
  }
}

// Launch 3. A block per (lane, acceptor row).
template <bool CRASH>
__global__ void __launch_bounds__(THREADS)
paxos_prepare_kernel(const uint8_t* __restrict__ prep_del,
                     const int32_t* __restrict__ props,
                     const int32_t* __restrict__ promised,
                     int32_t* __restrict__ new_promised,
                     const unsigned char* __restrict__ flags, int n_prop,
                     int N, int S, bool in_smem) {
  extern __shared__ int32_t smem[];
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / N);
  const int32_t* lane = props + static_cast<long long>(b) * 4 * N;
  const long long cell = row * S;
  int32_t* pm = in_smem ? smem : new_promised + cell;
  for (int s = threadIdx.x; s < S; s += THREADS) pm[s] = 0;
  __syncthreads();
  const uint8_t* dt = prep_del + row * N;
  for (int p = threadIdx.x; p < n_prop; p += THREADS) {
    if (lane[ctt::PROP_FLAG * N + p] && dt[p])
      atomicMax(pm + lane[ctt::PROP_SLOT * N + p],
                lane[ctt::PROP_BALLOT * N + p]);
  }
  __syncthreads();
  const bool rec = CRASH && (flags[row] & ctt::CRASH_REC);
  for (int s = threadIdx.x; s < S; s += THREADS)
    new_promised[cell + s] = rec ? pm[s] : max(promised[cell + s], pm[s]);
}

// Launch 4. A block per (proposer chunk, acceptor tile, lane), flattened
// in that order.
template <bool CRASH, bool SWITCH, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
paxos_promise_tile_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                          ctt::SwitchArgs sw,
                          const uint8_t* __restrict__ deliver,
                          const uint8_t* __restrict__ prep_del,
                          const int32_t* __restrict__ props,
                          const int32_t* __restrict__ promised,
                          const int32_t* __restrict__ new_promised,
                          const int32_t* __restrict__ acc_bal,
                          int32_t* __restrict__ n_prom,
                          int32_t* __restrict__ n_pair,
                          unsigned long long* __restrict__ keys,
                          const unsigned char* __restrict__ flags, int N,
                          int S, const long long* __restrict__ knobs) {
  const ctt::TileBlock tb = ctt::tile_block(N);
  const int p = tb.p;
  if (p >= N) return;
  const int b = tb.b;
  if (KNOBS) {
    sw.drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    sw.part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
  }
  const int32_t* lane = props + static_cast<long long>(b) * 4 * N;
  const bool is_prop = lane[ctt::PROP_FLAG * N + p];
  const int32_t slot = lane[ctt::PROP_SLOT * N + p];
  const int32_t ballot = lane[ctt::PROP_BALLOT * N + p];
  const int a0 = tb.a0;
  const int a1 = min(a0 + ctt::TILE_ROWS, N);
  int count = 0, pairs = 0;
  unsigned long long best = 0ull;
  if (SWITCH) {
    const ctt::SwitchLane sl = ctt::switch_lane(sw, seed[b], r, p);
    int seg = -1;
    bool down = false;
    for (int a = a0; a < a1; ++a) {
      const long long row = static_cast<long long>(b) * N + a;
      int32_t rep = 0;
      if (is_prop && prep_del[row * N + p]) {
        const long long c = row * S + slot;
        const int32_t held =
            CRASH && (flags[row] & ctt::CRASH_REC) ? 0 : promised[c];
        bool prom = false;
        if (ballot > held && ballot == new_promised[c] &&
            sw.g.up[(static_cast<long long>(b) * sw.g.phases) * N + a]) {
          const int ag = a / sw.g.seg;
          if (ag != seg) {
            seg = ag;
            down = ctt::switch_down(sw, sl, b, N, 0, ag);
          }
          prom = down;
        }
        if (prom) {
          ++count;
          rep = acc_bal[c];
        }
        pairs += prom || deliver[row * N + p];
      }
      const unsigned long long key = pack(rep, a);
      best = key > best ? key : best;
    }
  } else {
  for (int a = a0; a < a1; ++a) {
    const long long row = static_cast<long long>(b) * N + a;
    int32_t rep = 0;
    if (is_prop && prep_del[row * N + p] && deliver[row * N + p]) {
      ++pairs;
      const long long c = row * S + slot;
      const int32_t held =
          CRASH && (flags[row] & ctt::CRASH_REC) ? 0 : promised[c];
      if (ballot > held && ballot == new_promised[c]) {
        ++count;
        rep = acc_bal[c];
      }
    }
    const unsigned long long key = pack(rep, a);
    best = key > best ? key : best;
  }
  }
  const long long i = static_cast<long long>(b) * N + p;
  if (count) atomicAdd(n_prom + i, count);
  if (n_pair != nullptr && pairs) atomicAdd(n_pair + i, pairs);
  atomicMax(keys + i, best);
}

// Launch 5. A thread per (lane, proposer).
__global__ void __launch_bounds__(THREADS)
paxos_unpack_kernel(const unsigned long long* __restrict__ keys,
                    int32_t* __restrict__ best_bal,
                    int32_t* __restrict__ best_a, long long rows) {
  const long long i =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= rows) return;
  const unsigned long long key = keys[i];
  best_bal[i] = static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^
                                     0x80000000u);
  best_a[i] = static_cast<int32_t>(0xFFFFFFFFu -
                                   static_cast<uint32_t>(key & 0xFFFFFFFFull));
}

}  // namespace

// knobs is a knob batch's [B, 12] table (knobs.cuh; null but in a knob
// batch): churn_cut, drop_cut and part_cut are then the base's and each
// lane reads its own.
extern "C" int ctt_paxos_promise(
    const uint32_t* seed, uint32_t r, const uint8_t* deliver,
    const int32_t* promised, const int32_t* acc_bal, int32_t* new_promised,
    int32_t* n_prom, int32_t* best_bal, int32_t* best_a, uint8_t* prep_del,
    int32_t* n_pair, int32_t* props, unsigned long long* keys,
    const unsigned char* flags, int P, uint32_t churn_cut, int B, int N,
    int S, const unsigned char* up, const int32_t* tab, int K,
    uint32_t drop_cut, uint32_t part_cut, uint32_t max_delay,
    const long long* knobs, cudaStream_t st) {
  if ((up == nullptr) != (tab == nullptr) ||
      (up != nullptr && (K < 1 || K > N)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  static bool configured = false;
  if (!configured) {
    int err = static_cast<int>(cudaFuncSetAttribute(
        paxos_prepare_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ctt::ROW_SMEM_MAX));
    if (err == 0)
      err = static_cast<int>(cudaFuncSetAttribute(
          paxos_prepare_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, ctt::ROW_SMEM_MAX));
    if (err != 0) return err;
    configured = true;
  }
  const bool crash = flags != nullptr;
  const long long rows = static_cast<long long>(B) * N;
  int err = static_cast<int>(
      cudaMemsetAsync(n_prom, 0, rows * sizeof(int32_t), st));
  if (err == 0)
    err = static_cast<int>(
        cudaMemsetAsync(keys, 0, rows * sizeof(unsigned long long), st));
  if (err == 0 && n_pair != nullptr)
    err = static_cast<int>(
        cudaMemsetAsync(n_pair, 0, rows * sizeof(int32_t), st));
  if (err != 0) return err;
  const unsigned row_blocks = static_cast<unsigned>((rows + THREADS - 1) /
                                                    THREADS);
  const auto propose = knobs != nullptr ? paxos_propose_kernel<true>
                                         : paxos_propose_kernel<false>;
  propose<<<row_blocks, THREADS, 0, st>>>(seed, r, props, P, churn_cut, N, S,
                                          rows, knobs);
  const int tiles = (N + 31) / 32;
  paxos_transpose_kernel<<<static_cast<unsigned>(static_cast<long long>(tiles) *
                                                 tiles * B),
                           dim3(32, 8), 0, st>>>(deliver, prep_del, N, tiles);
  const bool in_smem =
      static_cast<long long>(S) * sizeof(int32_t) <= ctt::ROW_SMEM_MAX;
  const auto prepare =
      crash ? paxos_prepare_kernel<true> : paxos_prepare_kernel<false>;
  prepare<<<static_cast<unsigned>(rows), THREADS,
            in_smem ? S * sizeof(int32_t) : 0, st>>>(
      prep_del, props, promised, new_promised, flags, P < N ? P : N, N, S,
      in_smem);
  const bool sw_on = up != nullptr;
  // Only a switch round's tiles read a cutoff, so only they have KNOBS
  // instances.
  const auto promise =
      sw_on && knobs != nullptr
          ? (crash ? paxos_promise_tile_kernel<true, true, true>
                   : paxos_promise_tile_kernel<false, true, true>)
      : crash ? (sw_on ? paxos_promise_tile_kernel<true, true, false>
                       : paxos_promise_tile_kernel<true, false, false>)
              : (sw_on ? paxos_promise_tile_kernel<false, true, false>
                       : paxos_promise_tile_kernel<false, false, false>);
  const ctt::SwitchArgs sw =
      ctt::switch_args(up, tab, K, 2, N, drop_cut, part_cut, max_delay);
  promise<<<ctt::tile_blocks(B, N), THREADS, 0, st>>>(
      seed, r, sw, deliver, prep_del, props, promised, new_promised, acc_bal,
      n_prom, n_pair, keys, flags, N, S, knobs);
  paxos_unpack_kernel<<<row_blocks, THREADS, 0, st>>>(keys, best_bal, best_a,
                                                       rows);
  return static_cast<int>(cudaGetLastError());
}
