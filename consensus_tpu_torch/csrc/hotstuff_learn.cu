// Kernel KAF: the last step of a chained HotStuff round (SPEC §7b): P6's
// learning and QC notify, P7's per-node pacemaker, the next round's P1
// extremes and, with telemetry, the round's counters and flight recorder.
//
// Replaces: consensus_tpu/engines/hotstuff.py hotstuff_round (K18, lines
// 456-480) on its flat path, and with telemetry its tail (lines 485-519)
// with consensus_tpu/ops/viewsync.py sync_counts (K22) and ops/flight.py
// bucket_counts. With the round's V* and vote count (the lane's VSTAR and
// COUNTED words, from kernel KAE's last block; the QC formed when V* >= 0
// and the count reached Q = 2f + 1): a receiver of the proposal enters V* +
// 1 on a QC, else V*, and grows its committed prefix to the OLD gcommit
// (line 464: the commit as of proposal time, while KAE wrote the new one to
// a fresh output); a node with neither a proposal nor a P1 catch-up whose
// timer + 1 reaches view_timeout moves to the next view; the timer restarts
// on progress or timeout. Each node's key of its new view (hotstuff.cuh
// view_key) goes into the lane's TOP word by atomicMax, which KAE emptied:
// P1 of the next round reads it, so the round stays at three launches.
// Counters, in HOTSTUFF_TELEMETRY order: qc_formed, blocks_committed (new
// gcommit - old), commits_learned (the sum of the prefixes' growth, int32
// wrapping), view_changes (the timeouts; kernel KAJ adds the premature ones
// of SPEC §B), proposals_delivered, votes_counted,
// then the crash, aggregation and safety tails, which stay 0 here (kernel KAH
// adds the crash tail; the port rejects the other gates), and the SPEC §B
// tail: view_spread_max (max - min of the new views, int32 wrapping, over
// every node, honest all; in the CRASH instance over the nodes up),
// desync_rounds (spread > 0) and sync_msgs_delivered (the P1 catch-ups).
// Histograms: view_change_wait_rounds (timer + 1 of each node whose view
// moved: a QC learned, a catch-up or a timeout) and chain_commit_lag_rounds
// (one observation a round, new b1_h + 1 - new gcommit), bucketed as
// bucket_counts does (bucket 0 holds values <= 0, bucket i in 1..14 holds
// [2^(i-1), 2^i), bucket 15 values >= 2^14).
//
// Bound: bytes. Each node reads its view after P1, timer and prefix (12
// bytes) and two flags (2 bytes) and writes its view, timer and prefix (12
// bytes): 20.8 MB at hotstuff-100k (B = 8, N = 100 000), 6.2 us at 3.35
// TB/s; about 20 integer operations a node. With telemetry add nothing but
// the accumulators' few words.
// Design: a thread per (lane, node), the (lane, tile) pairs flattened into
// gridDim.x; the lane's V*, QC and old gcommit read once a block into shared
// memory. The next round's P1 key is a warp shuffle maximum, the warps'
// maxima merged by thread 0 and one 64-bit atomicMax a block. With the
// optional accumulators (t, and w and lat for the recorder: null pointers
// when off, so the telemetry costs nothing then) the counters are warp
// sums, one shared atomic a warp and one global atomic a block and counter;
// the wait histogram is warp-aggregated (__match_any_sync) into shared
// bins; the new views' minimum goes into VMIN by one 64-bit atomicMin a
// block; then the block counts itself done in DONE_LEARN, and the lane's
// last block (KAA's last-block-done pattern, pbft_telemetry.cu) adds the
// lane's counters (QC, commit, votes, spread, desync) and the lag bucket,
// and leaves VMIN and DONE_LEARN at rest. So telemetry adds no launch and no
// memset to the round.
// The CRASH instance (SPEC §6c, picked where the round's flag word of kernel
// KAH is given, with the round's input view and timer) computes every
// node's round as the JAX round does, down nodes included, and counts it so
// (lines 469-480 and 504-519: a down node's timeouts and waits count, from
// its in-round timer, which kernel KAJ skewed), then writes a node down at
// the round's end its frozen view, timer and prefix: its input view and
// timer, 0 where it recovered this round (both flag bits: 0 too), and its
// prefix, which no delivery moved (lines 473-480). The frozen values are
// KAJ's inputs, never its skewed outputs. The new views' keys (into TOP)
// and minimum (VMIN) are taken over the nodes up at the round's end, so the
// view spread is theirs (line 504), 0 where none is up; TOP is no P1 key
// on such a run (KAD reads KEY).
// Its BYZ instances (SPEC §3c/§7c, picked with byzantine nodes: the ids
// N - nb and up) take TOP's key and the view spread over the honest nodes
// only, in both modes (lines 266, 504): P1 of the next round reads an
// honest gossiper off TOP, so a byzantine round stays at three launches.
// The equivocate instances read the QC off QCF (KAE's last block: either
// variant's quorum), set the FBIT word in the fvec of each node that KAE
// marked deceived (in place; line 451) and, with telemetry, count the
// conflicting commits: a node whose committed prefix crossed a fork
// table row's height this round, with that row's bit in its new fvec
// (lines 494-502), summed into the CONF word; the lane's last block adds
// forked_qc (QCF's bit 1), conflict_commits and safety_violations.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "hotstuff.cuh"

namespace {

constexpr int BUCKETS = 16;
constexpr int HISTS = 2;
// HOTSTUFF_TELEMETRY's indexes (view_changes and proposals_delivered are 3
// and 4, after C_LEARNED).
constexpr int C_QC = 0, C_COMMITTED = 1, C_LEARNED = 2, C_VOTES = 5,
              C_FORKED = 12, C_CONFLICT = 13, C_UNSAFE = 14, C_SPREAD = 15,
              C_DESYNC = 16, C_SYNC = 17, K = 18;
constexpr int FORK_TABLE = 8;

// The fork state the equivocate instances read: KAE's deceived flags, the
// fork bits (updated in place), the fork table's heights and row count
// after KAE's update.
struct Fork {
  const bool* deceived;  // [B, N]
  int32_t* fvec;         // [B, N]
  const int32_t* ftab_h; // [B, FORK_TABLE]
  const int32_t* fnum;   // [B]
};
// The block's sums: commits_learned, view_changes, proposals_delivered (the
// counters from C_LEARNED on, in order) and sync_msgs_delivered.
constexpr int SUMS = 4;

__device__ __forceinline__ int sum_index(int k) {
  return k < SUMS - 1 ? C_LEARNED + k : C_SYNC;
}

__device__ __forceinline__ int lat_bucket(int32_t v) {
  if (v <= 0) return 0;
  return min(32 - __clz(v), BUCKETS - 1);
}

__device__ __forceinline__ void add(int* tb, int* wb, int k, int v) {
  if (v == 0) return;
  atomicAdd(tb + k, v);
  if (wb != nullptr) atomicAdd(wb + k, v);
}

template <bool CRASH, int BYZ>
__global__ void __launch_bounds__(hs::THREADS)
hotstuff_learn_kernel(const int32_t* __restrict__ view1,
                      const bool* __restrict__ pdel,
                      const bool* __restrict__ adv,
                      const int32_t* __restrict__ timer,
                      const int32_t* __restrict__ clen,
                      long long* __restrict__ lane,
                      const int32_t* __restrict__ gcommit,
                      const int32_t* __restrict__ b1_h_new,
                      const int32_t* __restrict__ gcommit_new,
                      int32_t* __restrict__ out, int* __restrict__ t,
                      int* __restrict__ w, int* __restrict__ lat,
                      const unsigned char* __restrict__ flags,
                      const int32_t* __restrict__ view_in,
                      const int32_t* __restrict__ timer_in, int Q,
                      int view_timeout, int B, int N, int window,
                      int n_windows, int tiles, int n_honest, Fork fork) {
  constexpr bool EQUIV = BYZ == ctt::BYZ_EQUIV;
  // Whether a node may be left out of TOP and VMIN: down or byzantine.
  constexpr bool SOME = CRASH || BYZ != ctt::BYZ_NONE;
  __shared__ int32_t s_vstar, s_gold;
  __shared__ bool s_qc;
  __shared__ int32_t s_fbit, s_fnum, s_fh[FORK_TABLE];
  __shared__ int s_conf;
  __shared__ long long s_key[hs::WARPS];
  __shared__ int32_t s_min[hs::WARPS];
  __shared__ int s_sum[SUMS];
  __shared__ int s_hist[BUCKETS];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const bool telem = t != nullptr;
  long long* lw = lane + static_cast<long long>(b) * hs::LANE_WORDS;
  if (threadIdx.x == 0) {
    s_vstar = static_cast<int32_t>(lw[hs::VSTAR]);
    s_qc = EQUIV ? (lw[hs::QCF] & 1) != 0
                 : s_vstar >= 0 && lw[hs::COUNTED] >= Q;
    s_gold = gcommit[b];
    if (EQUIV) {
      s_fbit = static_cast<int32_t>(lw[hs::FBIT]);
      s_fnum = min(fork.fnum[b], FORK_TABLE);
      s_conf = 0;
    }
  }
  if (EQUIV && threadIdx.x < FORK_TABLE)
    s_fh[threadIdx.x] = fork.ftab_h[b * FORK_TABLE + threadIdx.x];
  if (threadIdx.x < SUMS) s_sum[threadIdx.x] = 0;
  if (threadIdx.x < BUCKETS) s_hist[threadIdx.x] = 0;
  __syncthreads();
  const long long plane = static_cast<long long>(B) * N;
  const int i = tile * hs::THREADS + static_cast<int>(threadIdx.x);
  long long key = hs::I64_MIN;
  int32_t vmin = 0x7FFFFFFF;
  bool up = false;
  int sums[SUMS] = {0, 0, 0, 0};
  int bin = -1, conf = 0;
  if (i < N) {
    const long long row = static_cast<long long>(b) * N + i;
    const bool pd = pdel[row], ad = adv[row];
    const int32_t tm = timer[row], cl = clen[row];
    int32_t v = view1[row];
    if (pd) v = s_qc ? hs::add_i32(s_vstar, 1) : s_vstar;
    const int32_t cl2 = pd ? max(cl, s_gold) : cl;
    const bool progress = pd || ad;
    const int32_t tick = hs::add_i32(tm, 1);
    const bool to = !progress && tick >= view_timeout;
    v = hs::add_i32(v, to);
    const unsigned char fl = CRASH ? flags[row] : 0;
    const bool down = CRASH && (fl & ctt::CRASH_DOWN);
    if (down) {
      const bool rec = fl & ctt::CRASH_REC;
      out[row] = rec ? 0 : view_in[row];
      out[plane + row] = rec ? 0 : timer_in[row];
    } else {
      out[row] = v;
      out[plane + row] = progress || to ? 0 : tick;
      if (BYZ == ctt::BYZ_NONE || i < n_honest) {
        key = hs::view_key(v, i, N);
        vmin = v;
        up = true;
      }
    }
    out[2 * plane + row] = cl2;
    if (EQUIV) {
      int32_t fv = fork.fvec[row];
      if (fork.deceived[row] && s_fbit != 0) {
        fv |= s_fbit;
        fork.fvec[row] = fv;
      }
      if (telem)
        for (int k = 0; k < s_fnum; ++k)
          conf += ((fv >> k) & 1) && s_fh[k] >= cl && s_fh[k] < cl2;
    }
    sums[0] = hs::sub_i32(cl2, cl);
    sums[1] = to;
    sums[2] = pd;
    sums[3] = ad;
    if (lat != nullptr && ((pd && s_qc) || ad || to)) bin = lat_bucket(tick);
  }
  key = hs::warp_max64(key);
  if (lane_id == 0) s_key[warp] = key;
  if (telem) {
    for (int k = 0; k < SUMS; ++k) {
      const int v = hs::warp_sum(sums[k]);
      if (lane_id == 0 && v) atomicAdd(&s_sum[k], v);
    }
    vmin = __reduce_min_sync(hs::FULL, vmin);
    if (lane_id == 0) s_min[warp] = vmin;
    if (lat != nullptr) {
      const unsigned peers = __match_any_sync(hs::FULL, bin);
      if (bin >= 0 && lane_id == __ffs(peers) - 1)
        atomicAdd(&s_hist[bin], __popc(peers));
    }
    if (EQUIV) {
      const int c = hs::warp_sum(conf);
      if (lane_id == 0 && c) atomicAdd(&s_conf, c);
    }
  }
  // CRASH, BYZ: whether a node of the block is up at the round's end and
  // honest (a block without one adds nothing to VMIN).
  const bool block_up = SOME ? __syncthreads_or(up) != 0
                             : (__syncthreads(), true);
  int* tb = telem ? t + static_cast<long long>(b) * K : nullptr;
  int* wb = w == nullptr ? nullptr
                         : w + (static_cast<long long>(b) * n_windows +
                                window) * K;
  if (telem && threadIdx.x < SUMS) add(tb, wb, sum_index(threadIdx.x),
                                       s_sum[threadIdx.x]);
  if (lat != nullptr && threadIdx.x < BUCKETS && s_hist[threadIdx.x])
    atomicAdd(&lat[static_cast<long long>(b) * HISTS * BUCKETS +
                   threadIdx.x],
              s_hist[threadIdx.x]);
  if (threadIdx.x != 0) return;
  long long bkey = s_key[0];
  for (int k = 1; k < hs::WARPS; ++k) bkey = max(bkey, s_key[k]);
  atomicMax(lw + hs::TOP, bkey);
  if (!telem) return;
  int32_t bmin = s_min[0];
  for (int k = 1; k < hs::WARPS; ++k) bmin = min(bmin, s_min[k]);
  if (block_up) atomicMin(lw + hs::VMIN, static_cast<long long>(bmin));
  unsigned long long* uw = reinterpret_cast<unsigned long long*>(lw);
  if (EQUIV && s_conf)
    atomicAdd(uw + hs::CONF, static_cast<unsigned long long>(s_conf));
  __threadfence();
  if (atomicAdd(uw + hs::DONE_LEARN, 1ull) !=
      static_cast<unsigned long long>(tiles - 1))
    return;
  __threadfence();
  // The lane's last block: the lane's counters, the spread and the lag.
  const int32_t vmax =
      static_cast<int32_t>(atomicMax(lw + hs::TOP, hs::I64_MIN) >> 32);
  const long long lo = atomicMin(lw + hs::VMIN, hs::I64_MAX);
  // CRASH, BYZ: no honest node up at the round's end leaves VMIN at rest:
  // spread 0.
  const int32_t spread = SOME && lo == hs::I64_MAX
                             ? 0
                             : hs::sub_i32(vmax, static_cast<int32_t>(lo));
  const int32_t gnew = gcommit_new[b];
  add(tb, wb, C_QC, s_qc);
  add(tb, wb, C_COMMITTED, hs::sub_i32(gnew, s_gold));
  add(tb, wb, C_VOTES, static_cast<int32_t>(lw[hs::COUNTED]));
  add(tb, wb, C_SPREAD, spread);
  add(tb, wb, C_DESYNC, spread > 0);
  if (EQUIV) {
    const int conflicts =
        static_cast<int>(atomicAdd(uw + hs::CONF, 0ull));
    add(tb, wb, C_FORKED, static_cast<int>((lw[hs::QCF] >> 1) & 1));
    add(tb, wb, C_CONFLICT, conflicts);
    add(tb, wb, C_UNSAFE, conflicts > 0);
    lw[hs::CONF] = 0;
  }
  if (lat != nullptr)
    atomicAdd(&lat[static_cast<long long>(b) * HISTS * BUCKETS + BUCKETS +
                   lat_bucket(hs::sub_i32(hs::add_i32(b1_h_new[b], 1),
                                          gnew))],
              1);
  lw[hs::VMIN] = hs::I64_MAX;
  lw[hs::DONE_LEARN] = 0;
}

}  // namespace

// out is [3, B, N] int32: the new view, timer and clen. lane is the state's
// [B, 13] int64 lane words (hotstuff.cuh): TOP emptied by KAE and, with
// telemetry, VMIN and DONE_LEARN at rest. t ([B, 18]), w ([B, n_windows, 18])
// and lat ([B, 2, 16]) are the int32 accumulators, t null without telemetry,
// w and lat null without the flight recorder (then window and n_windows are
// unused). flags is the round's [B, N] flag word of kernel KAH, view_in and
// timer_in the round's input view and timer ([B, N] int32): all three null
// without a crash, all three given with one. deceived ([B, N] bool), fvec
// ([B, N] int32, in place), ftab_h ([B, 8]) and fnum ([B]) are given
// exactly with byz = BYZ_EQUIV.
extern "C" int ctt_hotstuff_learn(
    const int32_t* view1, const bool* pdel, const bool* adv,
    const int32_t* timer, const int32_t* clen, long long* lane,
    const int32_t* gcommit, const int32_t* b1_h_new,
    const int32_t* gcommit_new, int32_t* out, int* t, int* w, int* lat,
    const unsigned char* flags, const int32_t* view_in,
    const int32_t* timer_in, int Q, int view_timeout, int B, int N,
    int window, int n_windows, int byz, int nb, const bool* deceived,
    int32_t* fvec, const int32_t* ftab_h, const int32_t* fnum,
    cudaStream_t st) {
  const bool equiv = byz == ctt::BYZ_EQUIV;
  if (nb < 0 || nb > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV ||
      equiv != (deceived != nullptr) || equiv != (fvec != nullptr) ||
      equiv != (ftab_h != nullptr) || equiv != (fnum != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((w == nullptr) != (lat == nullptr) || (t == nullptr && w != nullptr) ||
      (w != nullptr && (window < 0 || window >= n_windows)) ||
      (flags == nullptr) != (view_in == nullptr) ||
      (flags == nullptr) != (timer_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + hs::THREADS - 1) / hs::THREADS;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const Fork fork = {deceived, fvec, ftab_h, fnum};
  const bool crash = flags != nullptr;
  const auto kernel =
      byz == ctt::BYZ_SILENT
          ? (crash ? hotstuff_learn_kernel<true, ctt::BYZ_SILENT>
                   : hotstuff_learn_kernel<false, ctt::BYZ_SILENT>)
      : equiv ? (crash ? hotstuff_learn_kernel<true, ctt::BYZ_EQUIV>
                       : hotstuff_learn_kernel<false, ctt::BYZ_EQUIV>)
              : (crash ? hotstuff_learn_kernel<true, ctt::BYZ_NONE>
                       : hotstuff_learn_kernel<false, ctt::BYZ_NONE>);
  kernel<<<static_cast<unsigned>(blocks), hs::THREADS, 0, st>>>(
      view1, pdel, adv, timer, clen, lane, gcommit, b1_h_new, gcommit_new, out,
      t, w, lat, flags, view_in, timer_in, Q, view_timeout, B, N, window,
      n_windows, tiles, N - nb, fork);
  return static_cast<int>(cudaGetLastError());
}
