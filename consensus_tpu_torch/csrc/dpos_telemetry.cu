// Kernel KAB: the DPoS round's protocol telemetry and flight recorder,
// added into the run's accumulators once a round.
//
// Replaces: consensus_tpu/engines/dpos.py dpos_round's telemetry tail (K20
// tail, lines 183-198) on its flat path, with ops/flight.py bucket_counts.
// Counters, in DPOS_TELEMETRY order: blocks_appended (the round's appends,
// which kernel KX counts as it appends: n_app), missed_appends (V minus
// them), producer_rotations (r > 0 and round r's producer differs from
// round r - 1's), churn_slots (the round's churn event), then
// missed_slots and suppressed_slots: in the GATES instance (picked when
// miss_cut or suppress_cut is non-zero) the lane's raw SPEC §A.1 and §A.4
// draws of round r's producer (ctt::slot_missed, ctt::suppressed;
// dpos.py:186-189), counted whether or not the slot had anything left to
// skip, else 0. The crash tail is kernel KAH's to add. Histogram chain_lag_rounds: one observation a
// round, max(chain_len) - min(chain_len) over the lane's validators after
// the append, bucketed as bucket_counts does (bucket 0 holds values <= 0,
// bucket i in 1..14 holds [2^(i-1), 2^i), bucket 15 values >= 2^14).
//
// Bound: bytes. Each validator's chain length read once (4 bytes), a few
// words a lane: 0.4 MB at dpos-100k (B = 1, V = 100 000), 0.12 us at
// 3.35 TB/s. The launch's latency sets the time: dpos-100k is one KX
// launch a round (PERF.md §5), and this is a second.
// Design: one launch (after a memset of 16 bytes a lane of scratch), a
// block per 1 024 validators of a lane, the (lane, tile) pairs flattened
// into gridDim.x. The lag is a max and a min over the whole lane: each
// block merges its warp maxima of the order-mapped lengths and of their
// complements into the lane's scratch with atomicMax, fences and counts
// itself done; the lane's last block reads the extremes and adds the
// lane's counters, window and bucket. The counters need only the lane's
// scalars (n_app, two producer ids, the churn draw), which that block's
// thread 0 reads.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn cutoff and, in the GATES instance, its
// miss and suppress cutoffs from the lane's row of the table in place of
// the arguments, in the lane's last block; the base's miss and suppress
// cutoffs pick the GATES instance.
#include <cuda_runtime.h>

#include <cstdint>

#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;
constexpr int BUCKETS = 16;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int K_MIN = 9;
// Scratch words a lane: max key, max complemented key, blocks done.
constexpr int SPAN = 4;

__device__ __forceinline__ int lat_bucket(int32_t v) {
  if (v <= 0) return 0;
  return min(32 - __clz(v), BUCKETS - 1);
}

__device__ __forceinline__ void add(int* tb, int* wb, int k, int v) {
  if (v == 0) return;
  atomicAdd(tb + k, v);
  if (wb != nullptr) atomicAdd(wb + k, v);
}

template <bool GATES, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
dpos_telemetry_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                      const int32_t* __restrict__ producers,
                      const int32_t* __restrict__ chain_len,
                      const int32_t* __restrict__ n_app, int* __restrict__ t,
                      int* __restrict__ w, int* __restrict__ lat,
                      unsigned* __restrict__ span, int p_index,
                      int prev_index, int list_len, uint32_t churn_cut,
                      int V, int K, int window, int n_windows, int tiles,
                      uint32_t miss_cut, uint32_t suppress_cut,
                      uint32_t suppress_window,
                      const long long* __restrict__ knobs) {
  __shared__ unsigned s_span[2];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  if (threadIdx.x < 2) s_span[threadIdx.x] = 0u;
  __syncthreads();
  const int32_t* len = chain_len + static_cast<long long>(b) * V;
  uint32_t hi = 0u, lo = 0u;
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int v = tile * TILE + u * THREADS + static_cast<int>(threadIdx.x);
    if (v < V) {
      const uint32_t key = static_cast<uint32_t>(len[v]) ^ 0x80000000u;
      hi = max(hi, key);
      lo = max(lo, ~key);
    }
  }
  hi = __reduce_max_sync(FULL, hi);
  lo = __reduce_max_sync(FULL, lo);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&s_span[0], hi);
    atomicMax(&s_span[1], lo);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned* ls = span + static_cast<long long>(b) * SPAN;
  atomicMax(ls + 0, s_span[0]);
  atomicMax(ls + 1, s_span[1]);
  __threadfence();
  if (atomicAdd(ls + 2, 1u) != static_cast<unsigned>(tiles - 1)) return;
  __threadfence();
  // The lane's last block: its counters, window and bucket. A knob
  // batch's lane reads its cutoffs here, after the reduction.
  if (KNOBS) {
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    if (GATES) {
      miss_cut = ctt::knob(knobs, b, ctt::KNOB_MISS);
      suppress_cut = ctt::knob(knobs, b, ctt::KNOB_SUPPRESS);
    }
  }
  int* tb = t + static_cast<long long>(b) * K;
  int* wb = w == nullptr
                ? nullptr
                : w + (static_cast<long long>(b) * n_windows + window) * K;
  const int32_t* plist = producers + static_cast<long long>(b) * list_len;
  const int appended = n_app[b];
  add(tb, wb, 0, appended);
  add(tb, wb, 1, V - appended);
  add(tb, wb, 2, r > 0u && plist[p_index] != plist[prev_index]);
  add(tb, wb, 3, ctt::random_u32(seed[b], ctt::STREAM_CHURN, r, 0u, 0u) <
                     churn_cut);
  if (GATES) {
    const uint32_t p = static_cast<uint32_t>(plist[p_index]);
    add(tb, wb, 4, ctt::slot_missed(seed[b], r, p, miss_cut));
    add(tb, wb, 5, ctt::suppressed(seed[b], r, suppress_window, p,
                                   suppress_cut));
  }
  if (lat != nullptr) {
    const uint32_t kmax = atomicMax(ls + 0, 0u);
    const uint32_t kmin = ~atomicMax(ls + 1, 0u);
    atomicAdd(&lat[static_cast<long long>(b) * BUCKETS +
                   lat_bucket(static_cast<int32_t>(kmax - kmin))],
              1);
  }
}

}  // namespace

// span is scratch, [B, 4] uint32, zeroed here. n_app is kernel KX's count
// of the round's appends. p_index and prev_index are the entries of a
// lane's producer list (E * K long) of rounds r and max(r - 1, 0). w and
// lat are null when the flight recorder is off; then window and n_windows
// are unused. miss_cut and suppress_cut are 0 on the flat path. knobs is a
// knob batch's [B, 12] table (knobs.cuh; null but in a knob batch): the
// cutoff arguments are then the base's, which pick the instance, and each
// lane reads its own from its row.
extern "C" int ctt_dpos_telemetry(const uint32_t* seed, uint32_t r,
                                  const int32_t* producers,
                                  const int32_t* chain_len,
                                  const int32_t* n_app, int* t, int* w,
                                  int* lat, unsigned* span, int p_index,
                                  int prev_index, int list_len,
                                  uint32_t churn_cut, int B, int V, int K,
                                  int window, int n_windows,
                                  uint32_t miss_cut, uint32_t suppress_cut,
                                  uint32_t suppress_window,
                                  const long long* knobs, cudaStream_t st) {
  if (K < K_MIN || (w == nullptr) != (lat == nullptr) ||
      (w != nullptr && (window < 0 || window >= n_windows)) ||
      p_index < 0 || p_index >= list_len || prev_index < 0 ||
      prev_index >= list_len || suppress_window == 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || V == 0) return 0;
  int err = static_cast<int>(cudaMemsetAsync(
      span, 0, sizeof(unsigned) * SPAN * static_cast<size_t>(B), st));
  if (err != 0) return err;
  const int tiles = (V + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool gates = miss_cut != 0u || suppress_cut != 0u;
  const auto kernel =
      knobs != nullptr
          ? (gates ? dpos_telemetry_kernel<true, true>
                   : dpos_telemetry_kernel<false, true>)
          : (gates ? dpos_telemetry_kernel<true, false>
                   : dpos_telemetry_kernel<false, false>);
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      seed, r, producers, chain_len, n_app, t, w, lat, span, p_index,
      prev_index, list_len, churn_cut, V, K, window, n_windows, tiles,
      miss_cut, suppress_cut, suppress_window, knobs);
  return static_cast<int>(cudaGetLastError());
}
