// Kernel KAJ: the prologue of a chained HotStuff round with a SPEC §6c or
// SPEC §B gate on: the recovery reset, the timer skew and its premature
// timeouts, and P1's key of the views after them over the nodes up.
//
// Replaces: consensus_tpu/engines/hotstuff.py hotstuff_round (K18, lines
// 207-230 and 266-268) with consensus_tpu/ops/viewsync.py desync_skew (K22,
// lines 40-53, as ctt::desync_skew). Kernel KAH (crash_transition.cu) ran
// the round's crash transition before it. Per node, in the JAX round's
// order: a node that recovered this round (the CRASH_REC bit of KAH's flag
// word) rejoins at view 0 and timer 0 (lines 211-212); then, with the skew
// on, its timer takes its skew, and where the skewed timer reaches
// view_timeout the node times out at once: view + 1, timer 0 (lines
// 225-230). Down nodes run all of it too (the JAX round skews every node;
// kernel KAF freezes a down node at its input after the reset, so it drops
// the skew). The views and timers go to fresh outputs. P1's key: the largest
// (view << 32) | (N - 1 - id) over the honest nodes up at the round's end
// (SPEC §3c/§7c: the ids below N - nb, passed as n_honest; every node
// without byzantine nodes), into the lane's KEY word (hotstuff.cuh), at
// rest KEY_REST = -1; kernel KAD reads it. Its high word is the JAX round's
// vM where that is >= 0 (the only case in which P1 gossips), and -1 else
// (no node up, or no view above -1), with M = N there; its low word gives
// the lowest id of the highest view. With telemetry the premature timeouts
// (every node's, down nodes' too: line 505-507) are added into the round's
// view_changes counter of the totals and of the round's window.
//
// Bound: bytes. Each node reads its view and timer (8 bytes) and its flag
// byte (with a crash), and writes its view and timer (8 bytes): 13.6 MB at
// hotstuff-100k (B = 8, N = 100 000), 4.1 us at 3.35 TB/s; with the skew,
// one Threefry draw a node and a second where it fires (about 119
// operations each), 2.8-5.7 us at 33.5e12 a second.
// Design: a thread per (lane, node), the (lane, tile) pairs flattened into
// gridDim.x. The key is a warp shuffle maximum, the warps' maxima merged by
// thread 0 and one 64-bit atomicMax a block (only where a node of the block
// is up with a view above -1); the premature timeouts are a warp sum and
// one atomic a block. The DESYNC and CRASH instances are picked at launch
// (desync_cut != 0, flags given); a run takes the same instance every round.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's desync cutoff from the lane's row of the
// table in place of the argument, whose base value still picks DESYNC.
#include <cuda_runtime.h>

#include "crash.cuh"
#include "hotstuff.cuh"
#include "knobs.cuh"

namespace {

template <bool DESYNC, bool CRASH, bool KNOBS>
__global__ void __launch_bounds__(hs::THREADS)
hotstuff_prologue_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                         const int32_t* __restrict__ view,
                         const int32_t* __restrict__ timer,
                         const unsigned char* __restrict__ flags,
                         long long* __restrict__ lane,
                         int32_t* __restrict__ out, int* __restrict__ t,
                         int* __restrict__ w, uint32_t desync_cut,
                         uint32_t max_skew, int view_timeout, int B, int N,
                         int K, int col, int window, int n_windows,
                         int tiles, int n_honest,
                         const long long* __restrict__ knobs) {
  __shared__ long long s_key[hs::WARPS];
  __shared__ int s_pre;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  if (KNOBS) desync_cut = ctt::knob(knobs, b, ctt::KNOB_DESYNC);
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  if (threadIdx.x == 0) s_pre = 0;
  __syncthreads();
  const int i = tile * hs::THREADS + static_cast<int>(threadIdx.x);
  long long key = hs::KEY_REST;
  int pre = 0;
  if (i < N) {
    const long long row = static_cast<long long>(b) * N + i;
    int32_t v = view[row], tm = timer[row];
    const unsigned char fl = CRASH ? flags[row] : 0;
    if (CRASH && (fl & ctt::CRASH_REC)) v = tm = 0;
    if (DESYNC) {
      tm = hs::add_i32(tm, ctt::desync_skew(seed[b], r,
                                            static_cast<uint32_t>(i),
                                            desync_cut, max_skew));
      if (tm >= view_timeout) {
        v = hs::add_i32(v, 1);
        tm = 0;
        pre = 1;
      }
    }
    out[row] = v;
    out[static_cast<long long>(B) * N + row] = tm;
    if (!(CRASH && (fl & ctt::CRASH_DOWN)) && i < n_honest)
      key = max(key, hs::view_key(v, i, N));
  }
  key = hs::warp_max64(key);
  if (lane_id == 0) s_key[warp] = key;
  if (DESYNC && t != nullptr) {
    const int p = hs::warp_sum(pre);
    if (lane_id == 0 && p) atomicAdd(&s_pre, p);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long bkey = s_key[0];
  for (int k = 1; k < hs::WARPS; ++k) bkey = max(bkey, s_key[k]);
  long long* lw = lane + static_cast<long long>(b) * hs::LANE_WORDS;
  if (bkey > hs::KEY_REST) atomicMax(lw + hs::KEY, bkey);
  if (DESYNC && t != nullptr && s_pre) {
    atomicAdd(t + static_cast<long long>(b) * K + col, s_pre);
    if (w != nullptr)
      atomicAdd(w + (static_cast<long long>(b) * n_windows + window) * K +
                    col,
                s_pre);
  }
}

}  // namespace

// out is [2, B, N] int32: the views and timers after the prologue. lane is
// the state's [B, 13] int64 lane words (hotstuff.cuh), KEY at rest. flags is
// the round's [B, N] flag word of kernel KAH (null without a crash). t ([B,
// K]) and w ([B, n_windows, K]) are the int32 telemetry accumulators (null
// without telemetry; w null without the flight recorder), col the column
// of view_changes. nb is the run's n_byzantine. knobs is a knob batch's
// [B, 12] table (knobs.cuh; null but in a knob batch).
extern "C" int ctt_hotstuff_prologue(const uint32_t* seed, uint32_t r,
                                     const int32_t* view,
                                     const int32_t* timer,
                                     const unsigned char* flags,
                                     long long* lane, int32_t* out, int* t,
                                     int* w, uint32_t desync_cut,
                                     uint32_t max_skew, int view_timeout,
                                     int B, int N, int K, int col, int window,
                                     int n_windows, int nb,
                                     const long long* knobs,
                                     cudaStream_t st) {
  const bool desync = desync_cut != 0u, crash = flags != nullptr;
  if ((!desync && !crash) || (desync && max_skew == 0u) || nb < 0 ||
      nb > N ||
      (t == nullptr && w != nullptr) ||
      (t != nullptr && (col < 0 || col >= K)) ||
      (w != nullptr && (window < 0 || window >= n_windows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + hs::THREADS - 1) / hs::THREADS;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      knobs != nullptr
          ? (crash ? (desync ? hotstuff_prologue_kernel<true, true, true>
                             : hotstuff_prologue_kernel<false, true, true>)
                   : hotstuff_prologue_kernel<true, false, true>)
          : (crash ? (desync ? hotstuff_prologue_kernel<true, true, false>
                             : hotstuff_prologue_kernel<false, true, false>)
                   : hotstuff_prologue_kernel<true, false, false>);
  kernel<<<static_cast<unsigned>(blocks), hs::THREADS, 0, st>>>(
      seed, r, view, timer, flags, lane, out, t, w, desync_cut, max_skew,
      view_timeout, B, N, K, col, window, n_windows, tiles, N - nb, knobs);
  return static_cast<int>(cudaGetLastError());
}
