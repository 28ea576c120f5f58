// Kernel KK: the round's protocol telemetry and flight recorder, added into
// the run's accumulators once a round.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round's
// telemetry tail (lines 503-525: the RAFT_TELEMETRY counter vector and the
// RAFT_LATENCY histograms), ops/flight.py bucket_counts (lines 29-46) and
// the accumulators that network/runner.py _chunk_body adds to the scan
// (lines 148-160: the [B, K] counter sum, the [B, n_windows, K] window
// ring at r // W and the [B, 2, 16] latency buckets).
//
// Counters, in RAFT_TELEMETRY order: leader_elections (winners of the
// round), append_accepted, append_rejected (has_l and not applied),
// entries_committed (the sum of commit minus commit at round entry),
// then attack_rounds: in the ATTACK instance (SPEC §A.3, picked when the
// round's attack word of kernel KE is given) the lane's word, the jam
// (elect) or the sticky activation (raft_sparse.py:509-514); the crash tail
// is kernel KAH's to add, the aggregation tail stays 0 (the port rejects
// the §9 switch). Histograms:
// election_wait_rounds (round-entry timer + 1 of each winner) and
// commit_lag_rounds (log_len - commit of each live leader), bucketed as
// bucket_counts does: bucket 0 holds values <= 0, bucket i in 1..14 holds
// [2^(i-1), 2^i), bucket 15 holds values >= 2^14.
//
// Bound: bytes. Per node it must read apply and commit at entry and now
// (9 bytes), has_l where apply is false, and with the recorder on also
// role (4 bytes); down only for leaders and log_len only for live ones, a
// few a sweep. At the flagship shape (B = 8, N = 100 000) that is at most
// 14 bytes a node, 11.2 MB, about 3.3 us at 3.35 TB/s. The accumulators
// are a few hundred bytes.
// Design: one launch, a thread per node on a (node, sweep) grid. Warp
// shuffles sum each counter, one shared atomic a warp per counter, and a
// 16-bin shared histogram; then a block adds its nonzero partials into
// the accumulators with integer atomics, which are exact in any order.
// Block 0 of each sweep also counts the sweep's A winners.
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

__device__ __forceinline__ int bucket(int32_t v) {
  if (v <= 0) return 0;
  return min(32 - __clz(v), BUCKETS - 1);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

template <bool ATTACK>
__global__ void __launch_bounds__(THREADS)
telemetry_kernel(const int32_t* __restrict__ cand_ids,
                 const bool* __restrict__ win,
                 const int32_t* __restrict__ timer_in,
                 const bool* __restrict__ has_l,
                 const bool* __restrict__ apply_,
                 const int32_t* __restrict__ commit_in,
                 const int32_t* __restrict__ commit,
                 const int32_t* __restrict__ role,
                 const int32_t* __restrict__ log_len,
                 const bool* __restrict__ down, int* __restrict__ t,
                 int* __restrict__ w, int* __restrict__ lat, int N, int A,
                 int K, int window, int n_windows,
                 const int32_t* __restrict__ atk) {
  __shared__ int s_count[COUNTED];
  __shared__ int s_hist[HISTS][BUCKETS];
  const int b = blockIdx.y;
  const bool flight = lat != nullptr;
  if (threadIdx.x < COUNTED) s_count[threadIdx.x] = 0;
  if (threadIdx.x < HISTS * BUCKETS) (&s_hist[0][0])[threadIdx.x] = 0;
  __syncthreads();
  const int j = blockIdx.x * THREADS + threadIdx.x;
  int acc = 0, rej = 0, dcom = 0;
  if (j < N) {
    const long long row = static_cast<long long>(b) * N + j;
    const bool ap = apply_[row];
    acc = ap;
    rej = has_l[row] && !ap;
    dcom = commit[row] - commit_in[row];
    if (flight && role[row] == ROLE_L && !down[row])
      atomicAdd(&s_hist[1][bucket(log_len[row] - commit[row])], 1);
  }
  acc = warp_sum(acc);
  rej = warp_sum(rej);
  dcom = warp_sum(dcom);
  if ((threadIdx.x & 31) == 0) {
    if (acc) atomicAdd(&s_count[1], acc);
    if (rej) atomicAdd(&s_count[2], rej);
    if (dcom) atomicAdd(&s_count[3], dcom);
  }
  if (blockIdx.x == 0 && threadIdx.x < A) {
    const int i = b * A + threadIdx.x;
    if (win[i]) {
      atomicAdd(&s_count[0], 1);
      if (flight) {
        const int cid = min(max(cand_ids[i], 0), N - 1);
        const int32_t wait = static_cast<int32_t>(
            static_cast<uint32_t>(timer_in[static_cast<long long>(b) * N +
                                           cid]) + 1u);
        atomicAdd(&s_hist[0][bucket(wait)], 1);
      }
    }
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
  if (ATTACK && blockIdx.x == 0 && threadIdx.x == 0 && atk[b] != 0) {
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
extern "C" int ctt_telemetry(const int32_t* cand_ids, const bool* win,
                             const int32_t* timer_in, const bool* has_l,
                             const bool* apply_, const int32_t* commit_in,
                             const int32_t* commit, const int32_t* role,
                             const int32_t* log_len, const bool* down,
                             int* t, int* w, int* lat, int B, int N, int A,
                             int K, int window, int n_windows,
                             const int32_t* atk, cudaStream_t st) {
  if (A < 1 || A > THREADS || K <= ATTACK_COL ||
      (w == nullptr) != (lat == nullptr) ||
      (w != nullptr && (window < 0 || window >= n_windows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  const auto kernel = atk != nullptr ? telemetry_kernel<true>
                                     : telemetry_kernel<false>;
  kernel<<<grid, THREADS, 0, st>>>(cand_ids, win, timer_in, has_l, apply_,
                                   commit_in, commit, role, log_len, down, t,
                                   w, lat, N, A, K, window, n_windows, atk);
  return static_cast<int>(cudaGetLastError());
}
