// Kernel KP: the dense Raft round's protocol telemetry and flight recorder,
// added into the run's accumulators once a round.
//
// Replaces: consensus_tpu/engines/raft.py raft_round's telemetry tail (K14
// tail, lines 539-559: the RAFT_TELEMETRY counter vector and the
// RAFT_LATENCY histograms), with ops/flight.py bucket_counts (lines 29-46)
// and the accumulators that network/runner.py _chunk_body adds to the
// scan (lines 148-160: the [B, K] counter sum, the [B, n_windows, K]
// window ring at r // W and the [B, 2, 16] latency buckets).
//
// Counters, in RAFT_TELEMETRY order: leader_elections (the round's
// winners), append_accepted (applied appends), append_rejected (a leader
// heard, ack_to >= 0, and not applied), entries_committed (the sum of
// commit minus commit at round entry), then attack_rounds: in the ATTACK
// instance (SPEC §A.3, picked when the round's attack word of kernel KM is
// given) the lane's word, the jam (elect) or the sticky activation
// (raft.py:541-547); the crash tail is kernel KAH's to add, the
// aggregation tail stays 0 (the port rejects the §9 switch). Histograms: election_wait_rounds (round-entry
// timer + 1 of each winner) and commit_lag_rounds (log_len - commit of
// each live leader), bucketed as bucket_counts does: bucket 0 holds values
// <= 0, bucket i in 1..14 holds [2^(i-1), 2^i), bucket 15 values >= 2^14.
//
// Bound: bytes. Per node it must read its win, apply and commit flags and
// words (10 bytes), the ack target where not applied, and with the
// recorder on also its role (4 bytes), the down flag of each leader, the
// log length of each live one and the round-entry timer of each winner.
// At raft-1kx1k (B = 8, N = 1024) that is about 0.15 MB, 0.05 us at
// 3.35 TB/s: the launch's latency sets the time. The accumulators are a
// few hundred bytes.
// Design: one launch, a thread per node, as kernel KK, with the (sweep,
// node tile) pairs flattened into gridDim.x: warp shuffles sum each
// counter, one shared atomic a warp per counter and a 16-bin shared
// histogram each; then a block adds its nonzero partials into the
// accumulators with integer atomics, exact in any order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BUCKETS = 16;
constexpr int HISTS = 2;
constexpr int32_t ROLE_L = 2;
// Counters this kernel adds: leader_elections, append_accepted,
// append_rejected, entries_committed.
constexpr int COUNTED = 4;
// attack_rounds' column.
constexpr int ATTACK_COL = 4;

__device__ __forceinline__ int lat_bucket(int32_t v) {
  if (v <= 0) return 0;
  return min(32 - __clz(v), BUCKETS - 1);
}

__device__ __forceinline__ int warp_total(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

template <bool ATTACK>
__global__ void __launch_bounds__(THREADS)
dense_telemetry_kernel(const bool* __restrict__ win,
                       const int32_t* __restrict__ timer_in,
                       const int32_t* __restrict__ ack_to,
                       const bool* __restrict__ ack_ok,
                       const int32_t* __restrict__ commit_in,
                       const int32_t* __restrict__ commit,
                       const int32_t* __restrict__ role,
                       const int32_t* __restrict__ log_len,
                       const bool* __restrict__ down, int* __restrict__ t,
                       int* __restrict__ w, int* __restrict__ lat, int N,
                       int K, int window, int n_windows, int node_tiles,
                       const int32_t* __restrict__ atk) {
  __shared__ int s_count[COUNTED];
  __shared__ int s_hist[HISTS][BUCKETS];
  const int b = blockIdx.x / node_tiles;
  const int tile = blockIdx.x - b * node_tiles;
  const bool flight = lat != nullptr;
  if (threadIdx.x < COUNTED) s_count[threadIdx.x] = 0;
  if (threadIdx.x < HISTS * BUCKETS) (&s_hist[0][0])[threadIdx.x] = 0;
  __syncthreads();
  const int j = tile * THREADS + threadIdx.x;
  int won = 0, acc = 0, rej = 0, dcom = 0;
  if (j < N) {
    const long long row = static_cast<long long>(b) * N + j;
    const bool ap = ack_ok[row];
    won = win[row];
    acc = ap;
    rej = !ap && ack_to[row] >= 0;
    dcom = commit[row] - commit_in[row];
    if (flight) {
      if (won) {
        const int32_t wait = static_cast<int32_t>(
            static_cast<uint32_t>(timer_in[row]) + 1u);
        atomicAdd(&s_hist[0][lat_bucket(wait)], 1);
      }
      if (role[row] == ROLE_L && !down[row])
        atomicAdd(&s_hist[1][lat_bucket(log_len[row] - commit[row])], 1);
    }
  }
  won = warp_total(won);
  acc = warp_total(acc);
  rej = warp_total(rej);
  dcom = warp_total(dcom);
  if ((threadIdx.x & 31) == 0) {
    if (won) atomicAdd(&s_count[0], won);
    if (acc) atomicAdd(&s_count[1], acc);
    if (rej) atomicAdd(&s_count[2], rej);
    if (dcom) atomicAdd(&s_count[3], dcom);
  }
  __syncthreads();
  if (threadIdx.x < COUNTED) {
    const int v = s_count[threadIdx.x];
    if (v) {
      atomicAdd(&t[b * K + threadIdx.x], v);
      if (w != nullptr)
        atomicAdd(&w[(static_cast<long long>(b) * n_windows + window) * K +
                     threadIdx.x], v);
    }
  }
  if (ATTACK && tile == 0 && threadIdx.x == 0 && atk[b] != 0) {
    atomicAdd(&t[b * K + ATTACK_COL], 1);
    if (w != nullptr)
      atomicAdd(&w[(static_cast<long long>(b) * n_windows + window) * K +
                   ATTACK_COL], 1);
  }
  if (flight && threadIdx.x < HISTS * BUCKETS) {
    const int v = (&s_hist[0][0])[threadIdx.x];
    if (v) atomicAdd(&lat[b * HISTS * BUCKETS + threadIdx.x], v);
  }
}

}  // namespace

// w and lat are null when the flight recorder is off; then window and
// n_windows are unused. atk is null but under a SPEC §A.3 attack.
extern "C" int ctt_dense_telemetry(const bool* win, const int32_t* timer_in,
                                   const int32_t* ack_to, const bool* ack_ok,
                                   const int32_t* commit_in,
                                   const int32_t* commit,
                                   const int32_t* role,
                                   const int32_t* log_len, const bool* down,
                                   int* t, int* w, int* lat, int B, int N,
                                   int K, int window, int n_windows,
                                   const int32_t* atk, cudaStream_t st) {
  if (K <= ATTACK_COL || (w == nullptr) != (lat == nullptr) ||
      (w != nullptr && (window < 0 || window >= n_windows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int node_tiles = (N + THREADS - 1) / THREADS;
  const long long blocks = static_cast<long long>(node_tiles) * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = atk != nullptr ? dense_telemetry_kernel<true>
                                     : dense_telemetry_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      win, timer_in, ack_to, ack_ok, commit_in, commit, role, log_len, down,
      t, w, lat, N, K, window, n_windows, node_tiles, atk);
  return static_cast<int>(cudaGetLastError());
}
