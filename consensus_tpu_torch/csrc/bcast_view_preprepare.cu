// Kernel KT: the node bits, SPEC §6b P0 churn, P1 the per-side view
// catch-up, P2 timeouts and P3 pre-prepare of the broadcast PBFT round at
// every node of each lane, with the lane's population n_real and tolerance
// f read per lane.
//
// Replaces: consensus_tpu/engines/pbft_bcast.py pbft_bcast_round (K15)
// lines 380-408 and 455-551 on its flat path, with _kth_largest (lines
// 108-127), and the same phases of consensus_tpu/engines/pbft_sweep.py
// pbft_bcast_round_padded (K17) lines 313-437. A node i of lane b is real
// when i < n_real[b]; it is a sender when it is real and the delivery
// mixer draw keyed (r, i, i) is at or above drop_cut (its broadcast goes
// out whole, SPEC §6b), or, with max_delay > 0, a broadcast it sent in one
// of the last max_delay rounds and lost arrives now (SPEC §A.2 on the same
// self-edge key: pbft_bcast.py lines 381-386, pbft_sweep.py lines 316-321,
// K13 delayed_open as ctt::delayed_open, drawn only where the round's own
// draw dropped, for real nodes, in launch 1's DELAY instance, which the
// launch picks when max_delay > 0); its side is the Threefry draw (r, 1, i)
// & 1 in a round whose partition is active (a Threefry draw below
// part_cut), else 0. Each node's byte (bit 0 sender, bit 1 side) is
// written for KU and KV.
// P0: the churn event moves every view up by one. P1: per side, a1 and a2
// are the (f+1)-th and f-th largest post-P0 sender view of the side, as
// the JAX package's binary search over [0, vmax + 2) on view + 1 gives
// them (-1 when fewer senders, vmax when the rank is 0; a2 is INT32_MAX at
// f = 0); a sender takes a1, another node min(max(view, a1), a2), where
// that is above its view. P2: a node whose timer reached view_timeout
// moves to the next view. P3: the primary view mod n_real of a receiver's
// view offers its seen and uncommitted slots and its first unseen slot (a
// fresh value, Threefry keyed by its view and the slot); the receiver, if
// real, takes each offer, when the primary is itself or a sender of its
// side in its view, into a slot it has not seen in this view unless it
// prepared another value there.
//
// Bound: bytes. Each node reads its view and timer and writes them, its
// reset flag and its byte (18 bytes); each (node, slot) reads pp_seen,
// pp_view, pp_val, prepared and writes pp_seen, pp_view, pp_val (19
// bytes), and the primary's committed flags. At pbft-100k-bcast (B = 8,
// N = 100 000, S = 16) that is about 259 MB a round, 77 us at 3.35 TB/s.
// Design: three launches on the stream, after a memset of the histogram.
//  1. A thread per node draws its bits and, if it is a sender, adds its
//     post-P0 view + 1 (clamped to [1, vmax + 1]: the search never looks
//     past vmax + 1, and a view + 1 <= 0 counts at no searched value) into
//     its lane's histogram of its side: warp-aggregated shared-memory
//     atomics, then one global atomic a nonzero bin a block.
//  2. A thread per receiver runs P0, reads its side's a1 and a2, which
//     four warps of its block find first off the histogram's suffix sums
//     (a warp-wide scan from the top bin down: the largest t whose suffix
//     count reaches the rank is the binary search's answer), runs P1 and
//     P2, and notes its first unseen slot for P3; where the caller passes
//     catch_out, it writes whether P1 moved its view (the flags the
//     telemetry counts as sync_msgs_delivered).
//  3. A thread per four (receiver, slot) entries runs P3, reading the
//     primary's row and first unseen slot as they stood before P3, and
//     writes fresh outputs, so no receiver reads another's update.
// Its CRASH instances (SPEC §6c, picked when the round's flag word of kernel
// KAH is given): launches 1 and 2 read the view and timer of a node
// recovered this round as 0 (pbft_bcast.py:438-445), and launch 1 writes
// a node down at the round's end with bit 0 clear (its broadcast is
// dropped, line 402) and bit 2 set, which kernels KU and KV read. A down
// receiver's round is otherwise the JAX round's (the freeze comes last,
// kernel KAI), which the telemetry counts.
// Its DESYNC instances (SPEC §B, picked when desync_cut != 0) add each
// node's timer skew (K22 desync_skew, consensus_tpu/ops/viewsync.py:40-53,
// as ctt::desync_skew, keyed by the absolute id, padded ladder nodes
// included) to the timer launch 2 takes, after the CRASH reset and before
// P0 (pbft_bcast.py:446-453, pbft_sweep.py:353-360). Launch 2 is the only
// launch that reads the timer (launch 1 reads the views, launch 3 the
// post-P2 views), so the skew is drawn once a node. The freeze (KAI)
// restores a down node's timer from the round's input, so it drops the
// skew, as the JAX package's frozen capture does.
// Its BYZ instances (SPEC §3c/§7c, picked with byzantine nodes: node i of a
// lane is honest when i < n_real - nb, byz.cuh) keep bit 0 as it is (the
// broadcast goes out, honest or not: a byzantine primary's offer and kernel
// KAK's senders read it) and count only honest senders in P1: launch 1 adds
// only their views to the histogram and launch 2 lets only them take a1
// (pbft_bcast.py:470, 497-498). In launch 3 only an honest primary offers
// as above (line 511); the equivocate instance lets a byzantine primary p
// offer every slot to each real receiver j it reaches (p == j, or its bit 0
// and j's side), whatever the views, the value drawn from j's view and
// slot with subdraw 4 where p's stance toward j (ctt::equiv_stance,
// absolute ids) is set, else 3 (lines 519-545; pbft_sweep.py:410-431).
// That instance draws the stance and a value for each (receiver, slot) of a
// byzantine primary: the bound counts both.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn, drop and partition cutoffs (launch 1)
// and its churn and, in a DESYNC instance, desync cutoffs (launch 2) from
// the lane's row of the table in place of the arguments; launch 3 reads no
// cutoff.
#include <climits>

#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;  // launch 3's entries a thread
constexpr unsigned FULL = 0xFFFFFFFFu;
// The largest per-lane histogram kept in shared memory (both sides).
constexpr int SMEM_HIST_BYTES = 48 * 1024;

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

// Launches 1 and 2 run on B * tiles blocks, tiles = ceil(N / THREADS):
// block x is lane x / tiles, nodes THREADS (x mod tiles) on, so the lane
// count has no grid limit of its own; nb = vmax + 2 bins a side. BYZ: only
// honest senders (i < n_real - n_byz) count.
template <bool DELAY, bool CRASH, bool BYZ, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
bcast_senders_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                     uint32_t churn_cut, uint32_t drop_cut,
                     uint32_t part_cut, uint32_t max_delay,
                     const int32_t* __restrict__ n_real,
                     const int32_t* __restrict__ view,
                     uint8_t* __restrict__ bits_out, int* __restrict__ hist,
                     const unsigned char* __restrict__ flags, int N, int nb,
                     bool smem, int tiles, int n_byz,
                     const long long* __restrict__ knobs) {
  extern __shared__ int sh[];
  const int b = blockIdx.x / tiles;
  if (KNOBS) {
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
  }
  const int i = (blockIdx.x - b * tiles) * THREADS + threadIdx.x;
  int* lane_hist = hist + static_cast<long long>(b) * 2 * nb;
  int* h = smem ? sh : lane_hist;
  if (smem) {
    for (int k = threadIdx.x; k < 2 * nb; k += THREADS) h[k] = 0;
    __syncthreads();
  }
  int key = -1;
  if (i < N) {
    const uint32_t sd = seed[b];
    const uint32_t ui = static_cast<uint32_t>(i);
    const bool bc =
        ctt::mix_fin(ctt::mix_absorb(
            ctt::mix_absorb(
                ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), ui),
            ui)) >= drop_cut ||
        (DELAY && i < n_real[b] &&
         ctt::delayed_open(sd, r, ui, ui, drop_cut, max_delay));
    const long long row = static_cast<long long>(b) * N + i;
    const bool down = CRASH && (flags[row] & ctt::CRASH_DOWN);
    const bool hb = bc && i < n_real[b] && !down;
    uint32_t side = 0u;
    if (part_cut != 0u &&
        ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 0u, 0u) < part_cut)
      side = ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 1u, ui) & 1u;
    bits_out[row] = static_cast<uint8_t>(hb | (side << 1) | (down << 2));
    if (hb && (!BYZ || i < n_real[b] - n_byz)) {
      const int32_t vplus = wrap_add(entry<CRASH>(view, flags, row),
                                     churn_step(sd, r, churn_cut) + 1);
      if (vplus >= 1)
        key = static_cast<int>(side) * nb + min(vplus, nb - 1);
    }
  }
  // One atomic for each distinct bin of a warp.
  const unsigned peers = __match_any_sync(FULL, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[key], __popc(peers));
  if (smem) {
    __syncthreads();
    for (int k = threadIdx.x; k < 2 * nb; k += THREADS)
      if (h[k] != 0) atomicAdd(&lane_hist[k], h[k]);
  }
}

// Launch 2.
template <bool CRASH, bool DESYNC, bool BYZ, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
bcast_catchup_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                     uint32_t churn_cut, int32_t view_timeout,
                     uint32_t desync_cut, uint32_t max_skew,
                     const int32_t* __restrict__ f,
                     const int32_t* __restrict__ view,
                     const int32_t* __restrict__ timer,
                     const bool* __restrict__ pp_seen,
                     const uint8_t* __restrict__ bits,
                     const int* __restrict__ hist,
                     int32_t* __restrict__ view_out,
                     int32_t* __restrict__ timer_out,
                     bool* __restrict__ reset_out,
                     int32_t* __restrict__ fresh_out,
                     bool* __restrict__ catch_out,
                     const int32_t* __restrict__ n_real,
                     const unsigned char* __restrict__ flags, int N, int S,
                     int nb, int tiles, int n_byz,
                     const long long* __restrict__ knobs) {
  __shared__ int32_t stat[4];  // a1 side 0, a1 side 1, a2 side 0, a2 side 1
  const int b = blockIdx.x / tiles;
  if (KNOBS) {
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    if (DESYNC) desync_cut = ctt::knob(knobs, b, ctt::KNOB_DESYNC);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    const int side = warp & 1;
    const int fb = f[b];
    const int rank = warp < 2 ? fb + 1 : fb;
    int32_t res = -1;
    if (warp >= 2 && fb < 1) {
      res = INT_MAX;
    } else {
      const int* h = hist + (static_cast<long long>(b) * 2 + side) * nb;
      int carry = 0;
      for (int top = nb - 1; top >= 1; top -= 32) {
        const int t = top - lane;  // lane 0 holds the highest bin
        int x = t >= 1 ? h[t] : 0;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, x, o);
          if (lane >= o) x += y;
        }
        const int acc = carry + x;  // senders with view + 1 >= t
        const unsigned hit = __ballot_sync(FULL, t >= 1 && acc >= rank);
        if (hit) {
          res = top - (__ffs(hit) - 1) - 1;
          break;
        }
        carry = __shfl_sync(FULL, acc, 31);
      }
    }
    if (lane == 0) stat[warp] = res;
  }
  __syncthreads();
  const int j = (blockIdx.x - b * tiles) * THREADS + threadIdx.x;
  if (j >= N) return;
  const long long row = static_cast<long long>(b) * N + j;
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
  // P1 catch-up.
  const uint8_t bj = bits[row];
  const int side = (bj >> 1) & 1;
  const int32_t a1 = stat[side], a2 = stat[2 + side];
  const bool sender = (bj & 1) && (!BYZ || j < n_real[b] - n_byz);
  const int32_t vth = sender ? a1 : min(max(v, a1), a2);
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
  // The first unseen slot, read by P3 where this node is the primary.
  int fresh = S;
  for (int s = 0; s < S; ++s) {
    if (!pp_seen[row * S + s]) {
      fresh = s;
      break;
    }
  }
  fresh_out[row] = fresh;
}

// Launch 3. B * tiles blocks, tiles = ceil(N * S / (THREADS * PER_THREAD)),
// block x lane x / tiles: a thread per PER_THREAD (receiver, slot) entries
// of a lane, THREADS apart, so that each warp access is consecutive and a
// thread has several in flight.
template <int BYZ>
__global__ void __launch_bounds__(THREADS)
bcast_preprepare_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                        const int32_t* __restrict__ n_real,
                        const int32_t* __restrict__ view,
                        const uint8_t* __restrict__ bits,
                        const int32_t* __restrict__ fresh,
                        const bool* __restrict__ pp_seen,
                        const int32_t* __restrict__ pp_view,
                        const int32_t* __restrict__ pp_val,
                        const bool* __restrict__ prepared,
                        const bool* __restrict__ committed,
                        bool* __restrict__ seen_out,
                        int32_t* __restrict__ pview_out,
                        int32_t* __restrict__ pval_out, int N, int S,
                        int tiles, int n_byz) {
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const long long nodes = static_cast<long long>(b) * N;
  const int n = n_real[b];
  const uint32_t sd = seed[b];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int el = (tile * PER_THREAD + u) * THREADS + threadIdx.x;
    if (el >= N * S) break;
    const int j = el / S;
    const int s = el - j * S;
    const long long row = nodes + j;
    const long long e = row * S + s;
    const int32_t v = view[row];
    int p = v % n;  // the floor modulo of the JAX package's %
    if (p < 0) p += n;
    const long long prow = nodes + p;
    const int32_t vp = view[prow];
    // The primary's offer reaches j: j itself, or a sender of j's side,
    // in j's view. A primary in j's view maps that view to itself, so it
    // leads. BYZ: only an honest primary leads; an equivocating one (byzp)
    // offers in any view.
    const uint8_t pb = bits[prow];
    const bool reach =
        j < n && (p == j || ((pb & 1) && ((pb ^ bits[row]) & 2) == 0));
    const bool honest_p = BYZ == ctt::BYZ_NONE || p < n - n_byz;
    const bool byzp = BYZ == ctt::BYZ_EQUIV && !honest_p;
    const bool ok = reach && honest_p && vp == v;
    bool seen = pp_seen[e];
    int32_t pv = pp_view[e], val = pp_val[e];
    if (byzp && reach) {
      const uint32_t sub =
          ctt::equiv_stance(sd, r, static_cast<uint32_t>(p),
                            static_cast<uint32_t>(j))
              ? 4u
              : 3u;
      const int32_t mval = static_cast<int32_t>(
          ctt::random_u32(sd, ctt::STREAM_VALUE, static_cast<uint32_t>(v),
                          sub, static_cast<uint32_t>(s)));
      if ((!seen || pv < v) && (!prepared[e] || mval == val)) {
        seen = true;
        pv = v;
        val = mval;
      }
    } else if (ok) {
      const long long ps = prow * S + s;
      const bool pseen = pp_seen[ps];
      if ((pseen && !committed[ps]) || s == fresh[prow]) {
        const int32_t mval =
            pseen ? pp_val[ps]
                  : static_cast<int32_t>(ctt::random_u32(
                        sd, ctt::STREAM_VALUE, static_cast<uint32_t>(vp), 2u,
                        static_cast<uint32_t>(s)));
        if ((!seen || pv < v) && (!prepared[e] || mval == val)) {
          seen = true;
          pv = v;
          val = mval;
        }
      }
    }
    seen_out[e] = seen;
    pview_out[e] = pv;
    pval_out[e] = val;
  }
}

// Launch 1's instance for (delay, crash, byz) with or without the knob
// table, and launch 2's for (crash, desync, byz).
template <bool KNOBS>
decltype(&bcast_senders_kernel<false, false, false, false>) senders_instance(
    bool delay, bool crash, bool hon) {
  if (hon)
    return crash ? (delay ? bcast_senders_kernel<true, true, true, KNOBS>
                          : bcast_senders_kernel<false, true, true, KNOBS>)
                 : (delay ? bcast_senders_kernel<true, false, true, KNOBS>
                          : bcast_senders_kernel<false, false, true, KNOBS>);
  return crash ? (delay ? bcast_senders_kernel<true, true, false, KNOBS>
                        : bcast_senders_kernel<false, true, false, KNOBS>)
               : (delay ? bcast_senders_kernel<true, false, false, KNOBS>
                        : bcast_senders_kernel<false, false, false, KNOBS>);
}

template <bool KNOBS>
decltype(&bcast_catchup_kernel<false, false, false, false>) catchup_instance(
    bool crash, bool desync, bool hon) {
  if (hon)
    return crash ? (desync ? bcast_catchup_kernel<true, true, true, KNOBS>
                           : bcast_catchup_kernel<true, false, true, KNOBS>)
                 : (desync ? bcast_catchup_kernel<false, true, true, KNOBS>
                           : bcast_catchup_kernel<false, false, true, KNOBS>);
  return crash ? (desync ? bcast_catchup_kernel<true, true, false, KNOBS>
                         : bcast_catchup_kernel<true, false, false, KNOBS>)
               : (desync ? bcast_catchup_kernel<false, true, false, KNOBS>
                         : bcast_catchup_kernel<false, false, false, KNOBS>);
}

}  // namespace

// hist is scratch, [B, 2, vmax + 2] int32, zeroed here; fresh is scratch,
// [B, N] int32; catch_out, [B, N] bool, is null where the caller does not
// ask for P1's catch-up flags. knobs is a knob batch's [B, 12] table
// (knobs.cuh; null but in a knob batch).
extern "C" int ctt_bcast_view_preprepare(
    const uint32_t* seed, uint32_t r, uint32_t churn_cut, uint32_t drop_cut,
    uint32_t part_cut, uint32_t max_delay, int32_t view_timeout, int32_t vmax,
    uint32_t desync_cut, uint32_t max_skew, const int32_t* n_real,
    const int32_t* f, const int32_t* view,
    const int32_t* timer, const bool* pp_seen, const int32_t* pp_view,
    const int32_t* pp_val, const bool* prepared, const bool* committed,
    int32_t* view_out, int32_t* timer_out, bool* reset_out, bool* seen_out,
    int32_t* pview_out, int32_t* pval_out, uint8_t* bits_out, int* hist,
    int32_t* fresh, bool* catch_out, const unsigned char* flags, int B, int N,
    int S, int byz, int n_byz, const long long* knobs, cudaStream_t st) {
  if (n_byz < 0 || n_byz > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  if (vmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = vmax + 2;
  const size_t hist_bytes = sizeof(int) * 2 * static_cast<size_t>(nb);
  int err = static_cast<int>(
      cudaMemsetAsync(hist, 0, hist_bytes * static_cast<size_t>(B), st));
  if (err != 0) return err;
  const bool smem = hist_bytes <= SMEM_HIST_BYTES;
  const int tiles = (N + THREADS - 1) / THREADS;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool delay = max_delay != 0u, crash = flags != nullptr;
  const bool hon = byz != ctt::BYZ_NONE;
  const bool kn = knobs != nullptr;
  const auto senders =
      kn ? senders_instance<true>(delay, crash, hon)
         : senders_instance<false>(delay, crash, hon);
  senders<<<static_cast<unsigned>(blocks), THREADS, smem ? hist_bytes : 0,
            st>>>(seed, r, churn_cut, drop_cut, part_cut, max_delay, n_real,
                  view, bits_out, hist, flags, N, nb, smem, tiles, n_byz,
                  knobs);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const bool desync = desync_cut != 0u;
  if (desync && max_skew == 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto catchup =
      kn ? catchup_instance<true>(crash, desync, hon)
         : catchup_instance<false>(crash, desync, hon);
  catchup<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      seed, r, churn_cut, view_timeout, desync_cut, max_skew, f, view, timer,
      pp_seen, bits_out, hist, view_out, timer_out, reset_out, fresh,
      catch_out, n_real, flags, N, S, nb, tiles, n_byz, knobs);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const long long per_lane = static_cast<long long>(N) * S;
  if (per_lane == 0) return 0;
  if (per_lane > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long tile = static_cast<long long>(THREADS) * PER_THREAD;
  const long long tiles3 = (per_lane + tile - 1) / tile;
  if (tiles3 * B > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto preprepare =
      byz == ctt::BYZ_SILENT  ? bcast_preprepare_kernel<ctt::BYZ_SILENT>
      : byz == ctt::BYZ_EQUIV ? bcast_preprepare_kernel<ctt::BYZ_EQUIV>
                              : bcast_preprepare_kernel<ctt::BYZ_NONE>;
  preprepare<<<static_cast<unsigned>(tiles3 * B), THREADS, 0, st>>>(
      seed, r, n_real, view_out, bits_out, fresh, pp_seen, pp_view, pp_val,
      prepared, committed, seen_out, pview_out, pval_out, N, S,
      static_cast<int>(tiles3), n_byz);
  return static_cast<int>(cudaGetLastError());
}
