// Kernel KQ: SPEC §6 P0 churn, P1 the f+1 view catch-up, P2 timeouts and
// P3 pre-prepare of the dense PBFT round at every node of each lane, with
// the lane's population n_real and tolerance f read per lane.
//
// Replaces: consensus_tpu/engines/pbft.py pbft_round (K16) lines 209-261 on
// its flat path, with _vth_select (lines 72-93), and the same phases of
// consensus_tpu/engines/pbft_sweep.py pbft_round_padded (K17) lines
// 184-237: P0 the churn event moves every view up by one; P1 node j takes
// the (f+1)-th largest of {view[i] : i real, delivered to j} and its own
// view, undelivered senders counting as -1, the result clamped to
// [-1, 2 n_rounds + 2] as the binary search over that range gives it; P2 a
// node whose timer reached view_timeout moves to the next view; P3 the
// primary view mod n_real of a receiver's view offers its seen and
// uncommitted slots and its first unseen slot (a fresh value, Threefry
// keyed by its view and the slot), and the receiver takes each offer into
// a slot it has not seen in this view unless it prepared another value
// there. A node i is real when i < n_real of its lane; a padded node
// sends nothing, receives nothing and is never a primary.
//
// Bound: bytes. Each node reads its view and timer and writes them and
// its reset flag (17 bytes); P1 reads one delivery byte a sender it walks
// (at most N a receiver, f + 1 when the top views are delivered); P3 reads
// and writes each slot of each node (pp_seen, pp_view, pp_val, prepared:
// 10 bytes in, 9 out) and the primary's row (cached: a lane's receivers
// share their primary). At the f-ladder (B = 128, N = 385, S = 32) that
// is about 30 MB a round, 9 us at 3.35 TB/s.
// Design: three launches on the stream.
//  1. A thread per node ranks its post-P0 view within its lane (view
//     descending, ties by id) by counting over the lane's views, and
//     writes itself at that rank into the lane's order. P0 adds the same
//     value to every view of a lane, but the rank is taken on the post-P0
//     views as they wrap in int32, so that it holds for any input.
//  2. A thread per receiver j runs P0, then walks its lane's order: a
//     sender counts when it is j or a real sender delivered to j
//     (deliver[i, j], consecutive j: coalesced); the (f+1)-th that counts
//     gives the statistic, and the walk stops there. Then P1's catch-up
//     and P2; the post-P2 view, timer and reset are written and, where
//     the caller passes catch_out, whether P1 moved the view (the flags
//     the telemetry counts as sync_msgs_delivered).
//  3. A warp per receiver, a lane per slot, runs P3. The primary's row is
//     read from the inputs and every receiver writes fresh outputs, so a
//     primary that takes its own offer (it is delivered to itself) changes
//     nothing that another receiver reads. The primary's first unseen
//     slot comes from one ballot a 32-slot chunk.
// Its CRASH instances (SPEC §6c, picked when the round's flag word of kernel
// KAH is given) read the view and timer of a node recovered this round as 0
// in launches 1 and 2 (its volatile reset, pbft.py:189-196); the rest is
// the round as it was, down nodes included (KL cut their edges; the freeze
// comes last in the round, kernel KAI).
// Its DESYNC instances (SPEC §B, picked when desync_cut != 0) add each
// node's timer skew (K22 desync_skew, consensus_tpu/ops/viewsync.py:40-53,
// as ctt::desync_skew, keyed by the absolute id, padded ladder nodes
// included) to the timer launch 2 takes, after the CRASH reset and before
// P0 (pbft.py:199-207, pbft_sweep.py:175-182): a skewed timer can reach P2's
// timeout in this round. Launch 1 reads no timer. The freeze (KAI) restores
// a down node's timer from the round's input, so it drops the skew, as the
// JAX package's frozen capture does.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn cutoff (launches 1 and 2) and, in a
// DESYNC instance, desync cutoff (launch 2) from the lane's row of the
// table in place of the arguments; launch 3 reads no cutoff. The base's
// desync cutoff picks the DESYNC instance, so under a base with the desync
// off a lane's desync value is not read (as consensus_tpu/engines/pbft.py
// :205 gates it).
// Its BYZ instances (SPEC §3c/§6, picked with byzantine nodes: node i of a
// lane is honest when i < n_real - nb) count the views of honest senders
// only in P1's walk (a node's own view always counts) and let only an
// honest primary offer in P3, in both modes (pbft.py:171-175, 213-230). The
// equivocate instance of launch 3 lets a byzantine primary p offer every
// slot to each real receiver j it reaches (p == j or deliver[p, j]),
// whatever the views, with a value drawn from j's view, subdraw 4 where
// p's stance toward j (ctt::equiv_stance, absolute ids) is set, else 3
// (lines 244-255).
#include <climits>

#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// A node's view or timer as the round takes it: 0 where the node recovered
// this round (CRASH instances only).
template <bool CRASH>
__device__ __forceinline__ int32_t entry(const int32_t* __restrict__ x,
                                         const unsigned char* __restrict__ fl,
                                         long long at) {
  return CRASH && (fl[at] & ctt::CRASH_REC) ? 0 : x[at];
}

// The round's churn event of a lane, as 0 or 1 (the P0 view step).
__device__ __forceinline__ int32_t churn_step(uint32_t sd, uint32_t r,
                                              uint32_t churn_cut) {
  return churn_cut != 0u &&
         ctt::random_u32(sd, ctt::STREAM_CHURN, r, 0u, 0u) < churn_cut;
}

// Launch 1. A thread per (lane, node), flattened.
template <bool CRASH, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
pbft_rank_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                 uint32_t churn_cut, const int32_t* __restrict__ view,
                 int32_t* __restrict__ order,
                 const unsigned char* __restrict__ flags, int N,
                 long long rows, const long long* __restrict__ knobs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int i = static_cast<int>(row - static_cast<long long>(b) * N);
  if (KNOBS) churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
  const int32_t c = churn_step(seed[b], r, churn_cut);
  const long long nodes = static_cast<long long>(b) * N;
  const int32_t vi = wrap_add(entry<CRASH>(view, flags, nodes + i), c);
  int rank = 0;
  for (int k = 0; k < N; ++k) {
    const int32_t vk = wrap_add(entry<CRASH>(view, flags, nodes + k), c);
    rank += vk > vi || (vk == vi && k < i);
  }
  order[static_cast<long long>(b) * N + rank] = i;
}

// Launch 2. A thread per (lane, receiver), flattened.
template <bool CRASH, bool DESYNC, bool HONEST, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
pbft_catchup_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                    uint32_t churn_cut, int32_t view_timeout, int32_t vmax,
                    uint32_t desync_cut, uint32_t max_skew,
                    const bool* __restrict__ deliver,
                    const int32_t* __restrict__ n_real,
                    const int32_t* __restrict__ f,
                    const int32_t* __restrict__ view,
                    const int32_t* __restrict__ timer,
                    const int32_t* __restrict__ order,
                    int32_t* __restrict__ view_out,
                    int32_t* __restrict__ timer_out,
                    bool* __restrict__ reset_out,
                    bool* __restrict__ catch_out,
                    const unsigned char* __restrict__ flags, int N,
                    long long rows, int nb,
                    const long long* __restrict__ knobs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int j = static_cast<int>(row - static_cast<long long>(b) * N);
  if (KNOBS) {
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    if (DESYNC) desync_cut = ctt::knob(knobs, b, ctt::KNOB_DESYNC);
  }
  const long long nodes = static_cast<long long>(b) * N;
  // SPEC §B skew, then P0 churn.
  const uint32_t sd = seed[b];
  const int32_t c = churn_step(sd, r, churn_cut);
  int32_t v = wrap_add(entry<CRASH>(view, flags, row), c);
  int32_t t = entry<CRASH>(timer, flags, row);
  if (DESYNC)
    t = wrap_add(t, ctt::desync_skew(sd, r, static_cast<uint32_t>(j),
                                     desync_cut, max_skew));
  if (c) t = 0;
  bool reset = c != 0;
  // P1: the (f+1)-th largest of the counted views; -1 when fewer count
  // (the undelivered senders' -1 entries fill the column), and the top of
  // the search range when f + 1 <= 0 asks for nothing.
  const int n = n_real[b];
  // The senders whose views count: the real ones, the honest ones (BYZ).
  const int ns = HONEST ? n - nb : n;
  const int need = f[b] + 1;
  int32_t vth = vmax;
  if (need > 0) {
    vth = -1;
    int count = 0;
    const int32_t* ord = order + nodes;
    for (int q = 0; q < N; ++q) {
      const int i = ord[q];
      const bool counted =
          i == j || (i < ns && j < n && deliver[(nodes + i) * N + j]);
      if (counted && ++count == need) {
        vth = min(max(wrap_add(entry<CRASH>(view, flags, nodes + i), c), -1),
                  vmax);
        break;
      }
    }
  }
  const bool caught = vth > v;
  if (caught) {
    v = vth;
    t = 0;
    reset = true;
  }
  // P2 timeout.
  if (t >= view_timeout) {
    v = wrap_add(v, 1);
    t = 0;
    reset = true;
  }
  view_out[row] = v;
  timer_out[row] = t;
  reset_out[row] = reset;
  if (catch_out != nullptr) catch_out[row] = caught;
}

// Launch 3. A warp per (lane, receiver), flattened; a thread per slot.
template <int BYZ>
__global__ void __launch_bounds__(THREADS)
pbft_preprepare_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                       const bool* __restrict__ deliver,
                       const int32_t* __restrict__ n_real,
                       const int32_t* __restrict__ view,
                       const bool* __restrict__ pp_seen,
                       const int32_t* __restrict__ pp_view,
                       const int32_t* __restrict__ pp_val,
                       const bool* __restrict__ prepared,
                       const bool* __restrict__ committed,
                       bool* __restrict__ seen_out,
                       int32_t* __restrict__ pview_out,
                       int32_t* __restrict__ pval_out, int N, int S,
                       long long rows, int nb) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform in the warp
  const int b = static_cast<int>(row / N);
  const int j = static_cast<int>(row - static_cast<long long>(b) * N);
  const long long nodes = static_cast<long long>(b) * N;
  const int n = n_real[b];
  const int32_t v = view[row];
  int p = v % n;  // the floor modulo of the JAX package's %
  if (p < 0) p += n;
  const long long prow = nodes + p;
  const int32_t vp = view[prow];
  // The primary's offer reaches j: delivered or j itself, in j's view. A
  // primary in j's view maps that view to itself, so it leads. BYZ: only
  // an honest primary leads; an equivocating one (byzp) offers in any view.
  bool ok, byzp = false;
  if (BYZ == ctt::BYZ_NONE) {
    ok = j < n && vp == v && (p == j || deliver[prow * N + j]);
  } else {
    const bool honest_p = p < n - nb;
    byzp = BYZ == ctt::BYZ_EQUIV && !honest_p;
    ok = j < n && (honest_p ? vp == v : byzp) &&
         (p == j || deliver[prow * N + j]);
  }
  // The primary's first unseen slot (S when it has seen them all).
  int fresh = S;
  if (ok && !byzp) {
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const unsigned m =
          __ballot_sync(FULL, s < S && !pp_seen[prow * S + s]);
      if (m) {
        fresh = s0 + __ffs(m) - 1;
        break;
      }
    }
  }
  const uint32_t sd = seed[b];
  // An equivocating primary's subdraw toward j: 4 with its stance set.
  const uint32_t sub =
      byzp ? (ctt::equiv_stance(sd, r, static_cast<uint32_t>(p),
                                static_cast<uint32_t>(j))
                  ? 4u
                  : 3u)
           : 0u;
  for (int s = lane; s < S; s += 32) {
    const long long js = row * S + s;
    bool seen = pp_seen[js];
    int32_t pv = pp_view[js], val = pp_val[js];
    if (byzp) {
      // Only where the equivocating primary's offer reaches j (ok).
      const int32_t mval = static_cast<int32_t>(
          ctt::random_u32(sd, ctt::STREAM_VALUE, static_cast<uint32_t>(v),
                          sub, static_cast<uint32_t>(s)));
      if (ok && (!seen || pv < v) && (!prepared[js] || mval == val)) {
        seen = true;
        pv = v;
        val = mval;
      }
    } else if (ok) {
      const long long ps = prow * S + s;
      const bool pseen = pp_seen[ps];
      if ((pseen && !committed[ps]) || s == fresh) {
        const int32_t mval =
            pseen ? pp_val[ps]
                  : static_cast<int32_t>(ctt::random_u32(
                        sd, ctt::STREAM_VALUE, static_cast<uint32_t>(vp),
                        2u, static_cast<uint32_t>(s)));
        if ((!seen || pv < v) && (!prepared[js] || mval == val)) {
          seen = true;
          pv = v;
          val = mval;
        }
      }
    }
    seen_out[js] = seen;
    pview_out[js] = pv;
    pval_out[js] = val;
  }
}

// Launch 1's instance for crash with or without the knob table, and launch
// 2's for (crash, desync, byz).
template <bool KNOBS>
decltype(&pbft_rank_kernel<false, false>) rank_instance(bool crash) {
  return crash ? pbft_rank_kernel<true, KNOBS> : pbft_rank_kernel<false, KNOBS>;
}

template <bool KNOBS>
decltype(&pbft_catchup_kernel<false, false, false, false>) catchup_instance(
    bool crash, bool desync, bool hon) {
  if (hon)
    return crash ? (desync ? pbft_catchup_kernel<true, true, true, KNOBS>
                           : pbft_catchup_kernel<true, false, true, KNOBS>)
                 : (desync ? pbft_catchup_kernel<false, true, true, KNOBS>
                           : pbft_catchup_kernel<false, false, true, KNOBS>);
  return crash ? (desync ? pbft_catchup_kernel<true, true, false, KNOBS>
                         : pbft_catchup_kernel<true, false, false, KNOBS>)
               : (desync ? pbft_catchup_kernel<false, true, false, KNOBS>
                         : pbft_catchup_kernel<false, false, false, KNOBS>);
}

}  // namespace

// order is scratch: [B, N] int32; catch_out, [B, N] bool, is null where
// the caller does not ask for P1's catch-up flags. knobs is a knob batch's
// [B, 12] table (knobs.cuh; null but in a knob batch): the cutoff
// arguments are then the base's, which pick the instances (desync_cut != 0
// the DESYNC one), and each lane reads its own from its row.
extern "C" int ctt_pbft_view_preprepare(
    const uint32_t* seed, uint32_t r, uint32_t churn_cut,
    int32_t view_timeout, int32_t vmax, uint32_t desync_cut,
    uint32_t max_skew, const bool* deliver,
    const int32_t* n_real, const int32_t* f, const int32_t* view,
    const int32_t* timer, const bool* pp_seen, const int32_t* pp_view,
    const int32_t* pp_val, const bool* prepared, const bool* committed,
    int32_t* view_out, int32_t* timer_out, bool* reset_out, bool* seen_out,
    int32_t* pview_out, int32_t* pval_out, bool* catch_out, int32_t* order,
    const unsigned char* flags, int B, int N, int S, int byz, int nb,
    const long long* knobs, cudaStream_t st) {
  if (nb < 0 || nb > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long rows = static_cast<long long>(B) * N;
  const unsigned blocks = static_cast<unsigned>((rows + THREADS - 1) / THREADS);
  const bool crash = flags != nullptr, kn = knobs != nullptr;
  const auto rank =
      kn ? rank_instance<true>(crash) : rank_instance<false>(crash);
  rank<<<blocks, THREADS, 0, st>>>(seed, r, churn_cut, view, order, flags, N,
                                   rows, knobs);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const bool desync = desync_cut != 0u;
  if (desync && max_skew == 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool hon = byz != ctt::BYZ_NONE;
  const auto catchup = kn ? catchup_instance<true>(crash, desync, hon)
                          : catchup_instance<false>(crash, desync, hon);
  catchup<<<blocks, THREADS, 0, st>>>(
      seed, r, churn_cut, view_timeout, vmax, desync_cut, max_skew, deliver,
      n_real, f, view, timer, order, view_out, timer_out, reset_out,
      catch_out, flags, N, rows, nb, knobs);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const unsigned warp_blocks =
      static_cast<unsigned>((rows + WARPS - 1) / WARPS);
  const auto preprepare =
      byz == ctt::BYZ_SILENT  ? pbft_preprepare_kernel<ctt::BYZ_SILENT>
      : byz == ctt::BYZ_EQUIV ? pbft_preprepare_kernel<ctt::BYZ_EQUIV>
                              : pbft_preprepare_kernel<ctt::BYZ_NONE>;
  preprepare<<<warp_blocks, THREADS, 0, st>>>(
      seed, r, deliver, n_real, view_out, pp_seen, pp_view, pp_val, prepared,
      committed, seen_out, pview_out, pval_out, N, S, rows, nb);
  return static_cast<int>(cudaGetLastError());
}
