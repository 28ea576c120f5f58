// Kernel KAA: the PBFT rounds' protocol telemetry and flight recorder, for
// the dense engine and the §6b broadcast one alike, added into the run's
// accumulators once a round.
//
// Replaces: consensus_tpu/engines/pbft.py pbft_round's telemetry tail (K16
// tail, lines 377-422) and consensus_tpu/engines/pbft_bcast.py
// pbft_bcast_round's (K15 tail, lines 687-728) on their flat paths, with
// consensus_tpu/ops/viewsync.py sync_counts (K22, lines 56-70) and
// ops/flight.py bucket_counts. Each term is read off the round's own
// tensors: per (node, slot), prepare_quorums = prepared & ~prepared at
// round entry, prepare_missed = pp_seen & ~prepared, commit_quorums =
// committed after the tally & ~committed at entry, commit_missed =
// prepared & ~committed after the tally, commits_adopted = committed after
// the decide gossip & ~committed after the tally; per node, view_changes
// sums max(view - view at entry, 0) (int32, wrapping), and the SPEC §B
// tail takes the spread max - min of the end-of-round views of the lane's
// real live nodes (0 when there are none), desync_rounds = spread > 0 and
// sync_msgs_delivered = the P1 catch-ups. The crash, aggregation and
// safety tails stay 0: the port rejects those gates. Histograms:
// view_change_wait_rounds (the entry timer + 1 of each node whose view
// moved) and slot_commit_rounds (r - s of each (node, slot) committed this
// round), bucketed as bucket_counts does: bucket 0 holds values <= 0,
// bucket i in 1..14 holds [2^(i-1), 2^i), bucket 15 values >= 2^14.
//
// Bound: bytes. Six [B, N, S] bool flags read once (6 bytes a (node,
// slot)) and 18 bytes a node; at pbft-100k-bcast (B = 8, N = 100 000,
// S = 16) that is 91 MB, 27 us at 3.35 TB/s.
// Design: one launch (after a memset of 16 bytes a lane of scratch), a
// block per 256 nodes of a lane, the (lane, node tile) pairs flattened into
// gridDim.x. A thread per node reads its views, timer, catch-up and live
// flags; the block's threads then walk its nodes' slots, consecutive
// threads on consecutive bytes. Counts are summed by warp shuffles, one
// shared atomic a warp per counter, then one global integer atomic a block
// per counter; histogram bins are warp-aggregated (__match_any_sync) into
// shared bins and added once a block. The view spread is a max and a min
// over the whole lane, known only when every block of the lane is done: a
// block merges its order-mapped maximum and complemented minimum into the
// lane's scratch with atomicMax, fences, and counts itself done; the last
// block of the lane reads the lane's extremes and adds the spread and
// desync_rounds. So telemetry adds one kernel and one memset a round.
// Its CRASH instance (SPEC §6c, picked by a nonzero `crash` mode of
// engines/pbft.py): the round's tensors are read before the freeze, and
// `down` is the mask at the round's end, so a down node's view terms
// (view_changes, its view-change wait) are left out, its view being frozen
// (pbft.py:368-373); with mode bit CRASH_COMMITS (the §6b round, whose
// commits a down node never takes, pbft_bcast.py:355-356) its
// commit_quorums and slot commit latencies are too. The crash tail itself
// is kernel KAH's.
// Its BYZ instances (SPEC §3c/§7c, picked with byzantine nodes: node i of a
// lane is honest when i < n_real - nb) take the view spread over the honest
// live nodes, in both modes (pbft.py:410). The equivocate instance also
// counts the safety tail (lines 386-405): per slot, the extremes of pp_val
// over this round's honest commits by the tally (committed_tally &
// ~committed_in, without a down node's under CRASH_COMMITS, as the §6b
// round's commit_now, pbft_bcast.py:354-356, 700) and of the decided value
// over the honest committed nodes
// as the freeze leaves them (a down node's committed flag and dval at round
// entry); each block keeps a slot's two extremes' order keys (max key, max
// complemented key) in dynamic shared memory and merges them into the
// lane's scratch by atomicMax, and the lane's last block counts forked_qc
// (slots whose commits hold two values), conflict_commits (likewise for the
// decided values) and safety_violations (conflict_commits > 0).
#include <cuda_runtime.h>

#include <cstdint>

#include "byz.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BUCKETS = 16;
constexpr int HISTS = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;
// PBFT_TELEMETRY's indexes of the counters this kernel adds.
constexpr int C_VIEW = 5;      // view_changes; 0-4 are the slot counters
constexpr int C_FORKED = 12;   // forked_qc
constexpr int C_CONFLICT = 13; // conflict_commits
constexpr int C_UNSAFE = 14;   // safety_violations
constexpr int C_SPREAD = 15;   // view_spread_max
constexpr int C_DESYNC = 16;   // desync_rounds
constexpr int C_SYNC = 17;     // sync_msgs_delivered
constexpr int K_MIN = 18;
// Per-block sums: the five slot counters, view_changes, sync_msgs.
constexpr int SUMS = 7;
// Scratch words a lane: max key, max complemented key, live nodes, blocks
// done; in the equivocate instance then four a slot (the forked values' max
// key and max complemented key, the decided values' two).
constexpr int SPAN = 4;
// The slots the equivocate instance takes: its shared memory holds four
// words a slot.
constexpr int MAX_SAFETY_SLOTS = 3072;

__device__ __forceinline__ int lat_bucket(int32_t v) {
  if (v <= 0) return 0;
  return min(32 - __clz(v), BUCKETS - 1);
}

__device__ __forceinline__ int warp_total(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// int32 to uint32, order kept.
__device__ __forceinline__ uint32_t order_key(int32_t v) {
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}

template <bool CRASH, int BYZ>
__global__ void __launch_bounds__(THREADS)
pbft_telemetry_kernel(const int32_t* __restrict__ n_real,
                      const int32_t* __restrict__ view_in,
                      const int32_t* __restrict__ timer_in,
                      const int32_t* __restrict__ view,
                      const bool* __restrict__ caught,
                      const bool* __restrict__ down,
                      const bool* __restrict__ pp_seen,
                      const bool* __restrict__ prepared_in,
                      const bool* __restrict__ prepared,
                      const bool* __restrict__ committed_in,
                      const bool* __restrict__ committed_tally,
                      const bool* __restrict__ committed,
                      int* __restrict__ t, int* __restrict__ w,
                      int* __restrict__ lat, unsigned* __restrict__ span,
                      int r, int N, int S, int K, int window, int n_windows,
                      int tiles, bool commits, int nb,
                      const int32_t* __restrict__ pp_val,
                      const int32_t* __restrict__ dval_in,
                      const int32_t* __restrict__ dval) {
  constexpr bool EQUIV = BYZ == ctt::BYZ_EQUIV;
  __shared__ int s_sum[SUMS];
  __shared__ int s_hist[HISTS][BUCKETS];
  __shared__ unsigned s_span[3];
  extern __shared__ unsigned s_slot[];  // EQUIV: [4][S]
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const bool flight = lat != nullptr;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < SUMS) s_sum[threadIdx.x] = 0;
  if (threadIdx.x < HISTS * BUCKETS) (&s_hist[0][0])[threadIdx.x] = 0;
  if (threadIdx.x < 3) s_span[threadIdx.x] = 0u;
  if (EQUIV)
    for (int k = threadIdx.x; k < 4 * S; k += THREADS) s_slot[k] = 0u;
  __syncthreads();
  const long long nodes = static_cast<long long>(b) * N;
  // The nodes whose views the spread takes (and, EQUIV, whose commits the
  // safety tail reads): the real ones, the honest ones (BYZ).
  const int n_hon = n_real[b] - (BYZ != ctt::BYZ_NONE ? nb : 0);
  const int j0 = tile * THREADS;
  const int j1 = min(j0 + THREADS, N);

  // A thread per node.
  int sums[SUMS] = {0, 0, 0, 0, 0, 0, 0};
  uint32_t hi = 0u, lo = 0u;
  int live = 0;
  const int j = j0 + static_cast<int>(threadIdx.x);
  if (j < j1) {
    const long long row = nodes + j;
    const int32_t v = view[row], v0 = view_in[row];
    const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(v) -
                                           static_cast<uint32_t>(v0));
    const bool frozen = CRASH && down[row];
    sums[C_VIEW] = d > 0 && !frozen ? d : 0;
    sums[6] = caught[row];
    if (flight && v > v0 && !frozen)
      atomicAdd(&s_hist[0][lat_bucket(static_cast<int32_t>(
                    static_cast<uint32_t>(timer_in[row]) + 1u))],
                1);
    if (j < n_hon && !down[row]) {
      hi = order_key(v);
      lo = ~hi;
      live = 1;
    }
  }

  // The block's (node, slot) entries, a round of THREADS at a time (the
  // same trip count in every thread, so that whole warps match bins).
  const long long e0 = (nodes + j0) * S, e1 = (nodes + j1) * S;
  for (long long base = e0; base < e1; base += THREADS) {
    const long long e = base + threadIdx.x;
    int key = -1;
    if (e < e1) {
      const bool p = prepared[e], ct = committed_tally[e], c = committed[e];
      const bool cin = committed_in[e];
      const bool kept = !(CRASH && commits && down[e / S]);
      sums[0] += p && !prepared_in[e];
      sums[1] += pp_seen[e] && !p;
      sums[2] += ct && !cin && kept;
      sums[3] += p && !ct;
      sums[4] += c && !ct;
      if (flight && c && !cin && kept)
        key = lat_bucket(r - static_cast<int>(e % S));
      if (EQUIV && e / S - nodes < n_hon) {
        const int sl = static_cast<int>(e % S);
        if (ct && !cin && kept) {
          const uint32_t k = order_key(pp_val[e]);
          atomicMax(&s_slot[sl], k);
          atomicMax(&s_slot[S + sl], ~k);
        }
        const bool fz = CRASH && down[e / S];
        if (fz ? cin : c) {
          const uint32_t k = order_key(fz ? dval_in[e] : dval[e]);
          atomicMax(&s_slot[2 * S + sl], k);
          atomicMax(&s_slot[3 * S + sl], ~k);
        }
      }
    }
    if (flight) {
      const unsigned peers = __match_any_sync(FULL, key);
      if (key >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&s_hist[1][key], __popc(peers));
    }
  }

  for (int k = 0; k < SUMS; ++k) {
    const int v = warp_total(sums[k]);
    if (lane == 0 && v) atomicAdd(&s_sum[k], v);
  }
  hi = __reduce_max_sync(FULL, hi);
  lo = __reduce_max_sync(FULL, lo);
  live = warp_total(live);
  if (lane == 0 && live) {
    atomicMax(&s_span[0], hi);
    atomicMax(&s_span[1], lo);
    atomicAdd(&s_span[2], static_cast<unsigned>(live));
  }
  __syncthreads();

  int* tb = t + static_cast<long long>(b) * K;
  int* wb = w == nullptr
                ? nullptr
                : w + (static_cast<long long>(b) * n_windows + window) * K;
  if (threadIdx.x < SUMS) {
    const int v = s_sum[threadIdx.x];
    const int k = threadIdx.x < SUMS - 1 ? threadIdx.x : C_SYNC;
    if (v) {
      atomicAdd(tb + k, v);
      if (wb != nullptr) atomicAdd(wb + k, v);
    }
  }
  if (flight && threadIdx.x < HISTS * BUCKETS) {
    const int v = (&s_hist[0][0])[threadIdx.x];
    if (v)
      atomicAdd(&lat[static_cast<long long>(b) * HISTS * BUCKETS +
                     threadIdx.x],
                v);
  }

  unsigned* ls =
      span + static_cast<long long>(b) * (EQUIV ? SPAN + 4 * S : SPAN);
  if (EQUIV) {
    __syncthreads();  // every shared extreme of the block is in
    for (int k = threadIdx.x; k < 4 * S; k += THREADS)
      if (s_slot[k] != 0u) atomicMax(ls + SPAN + k, s_slot[k]);
    __threadfence();  // before thread 0 counts the block done
    __syncthreads();
  }

  // The lane's view spread, by its last block.
  if (threadIdx.x == 0) {
    if (s_span[2]) {
      atomicMax(ls + 0, s_span[0]);
      atomicMax(ls + 1, s_span[1]);
      atomicAdd(ls + 2, s_span[2]);
    }
    __threadfence();
    if (atomicAdd(ls + 3, 1u) == static_cast<unsigned>(tiles - 1)) {
      __threadfence();
      if (atomicAdd(ls + 2, 0u) != 0u) {
        const uint32_t kmax = atomicMax(ls + 0, 0u);
        const uint32_t kmin = ~atomicMax(ls + 1, 0u);
        const int32_t spread = static_cast<int32_t>(kmax - kmin);
        if (spread != 0) {
          atomicAdd(tb + C_SPREAD, spread);
          if (wb != nullptr) atomicAdd(wb + C_SPREAD, spread);
        }
        if (spread > 0) {
          atomicAdd(tb + C_DESYNC, 1);
          if (wb != nullptr) atomicAdd(wb + C_DESYNC, 1);
        }
      }
      if (EQUIV) {
        // A slot holds two values where its max key is not its min key;
        // no entry leaves both words 0 (one entry never does).
        int forked = 0, conflicts = 0;
        unsigned* x = ls + SPAN;
        for (int sl = 0; sl < S; ++sl) {
          const uint32_t fh = atomicMax(x + sl, 0u);
          const uint32_t fl = atomicMax(x + S + sl, 0u);
          const uint32_t ch = atomicMax(x + 2 * S + sl, 0u);
          const uint32_t cl = atomicMax(x + 3 * S + sl, 0u);
          forked += (fh | fl) != 0u && fh != ~fl;
          conflicts += (ch | cl) != 0u && ch != ~cl;
        }
        if (forked) {
          atomicAdd(tb + C_FORKED, forked);
          if (wb != nullptr) atomicAdd(wb + C_FORKED, forked);
        }
        if (conflicts) {
          atomicAdd(tb + C_CONFLICT, conflicts);
          atomicAdd(tb + C_UNSAFE, 1);
          if (wb != nullptr) {
            atomicAdd(wb + C_CONFLICT, conflicts);
            atomicAdd(wb + C_UNSAFE, 1);
          }
        }
      }
    }
  }
}

}  // namespace

// span is scratch, [B, 4] uint32 ([B, 4 + 4 S] in the equivocate
// instance), zeroed here. w and lat are null when the flight recorder is
// off; then window and n_windows are unused. pp_val (after P3), dval_in
// (at round entry) and dval (at the round's end, before the freeze), each
// [B, N, S] int32, are given exactly with byz = BYZ_EQUIV.
extern "C" int ctt_pbft_telemetry(
    const int32_t* n_real, const int32_t* view_in, const int32_t* timer_in,
    const int32_t* view, const bool* caught, const bool* down,
    const bool* pp_seen, const bool* prepared_in, const bool* prepared,
    const bool* committed_in, const bool* committed_tally,
    const bool* committed, int* t, int* w, int* lat, unsigned* span, int r,
    int B, int N, int S, int K, int window, int n_windows, int crash,
    int byz, int nb, const int32_t* pp_val, const int32_t* dval_in,
    const int32_t* dval, cudaStream_t st) {
  const bool equiv = byz == ctt::BYZ_EQUIV;
  if (K < K_MIN || (w == nullptr) != (lat == nullptr) ||
      (w != nullptr && (window < 0 || window >= n_windows)) || nb < 0 ||
      nb > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV ||
      equiv != (pp_val != nullptr) || equiv != (dval_in != nullptr) ||
      equiv != (dval != nullptr) || (equiv && S > MAX_SAFETY_SLOTS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int stride = equiv ? SPAN + 4 * S : SPAN;
  int err = static_cast<int>(cudaMemsetAsync(
      span, 0, sizeof(unsigned) * stride * static_cast<size_t>(B), st));
  if (err != 0) return err;
  const int tiles = (N + THREADS - 1) / THREADS;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool c = crash != 0;
  const auto kernel =
      byz == ctt::BYZ_SILENT
          ? (c ? pbft_telemetry_kernel<true, ctt::BYZ_SILENT>
               : pbft_telemetry_kernel<false, ctt::BYZ_SILENT>)
      : equiv ? (c ? pbft_telemetry_kernel<true, ctt::BYZ_EQUIV>
                   : pbft_telemetry_kernel<false, ctt::BYZ_EQUIV>)
              : (c ? pbft_telemetry_kernel<true, ctt::BYZ_NONE>
                   : pbft_telemetry_kernel<false, ctt::BYZ_NONE>);
  const size_t smem = equiv ? sizeof(unsigned) * 4 * S : 0;
  if (smem > 48 * 1024) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err != 0) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
      n_real, view_in, timer_in, view, caught, down, pp_seen, prepared_in,
      prepared, committed_in, committed_tally, committed, t, w, lat, span, r,
      N, S, K, window, n_windows, tiles, (crash & 2) != 0, nb, pp_val,
      dval_in, dval);
  return static_cast<int>(cudaGetLastError());
}
