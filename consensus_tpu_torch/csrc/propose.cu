// Kernel KI: SPEC §3 P3a, every leader's one-slot local append, and P3b, the
// snapshot of the tracked senders' state that P3c and P3d read.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round P3a
// (lines 377-383: a leader whose log holds fewer than E entries writes
// (term, value) at its log length, the value a Threefry draw of
// STREAM_VALUE keyed by (round, node), and its length grows by one) and
// P3b (lines 390-396: per tracked slot, whether it still leads, its term,
// length and commit, and its post-append [L] log rows). The JAX round
// rewrites both [N, L] logs with a masked select; here the append writes
// two words a leader, in place.
//
// Bound: bytes. Per node it reads the leader flag and the log length and
// writes the new length (9 bytes, 7.2 MB at the flagship shape, B = 8,
// N = 100 000); per appending leader one term and two log words; per slot
// two [L] rows read and written (64 KB at A = 8, L = 128). About 2.2 us at
// 3.35 TB/s. The Threefry draw (~119 integer operations) runs only for
// the leaders that append.
// Design: two launches on the stream. Launch 1, a thread per node on a
// (node, sweep) grid, appends and writes the new length. Launch 2, a block
// per (sweep, slot), reads its leader's row after the append (the stream
// orders the two launches, so no race decides what the snapshot sees):
// thread 0 writes the slot's scalars and the block copies the two rows.
// Its BYZ instance (SPEC §3c, picked with silent byzantine nodes) marks a
// byzantine leader's slot unsent in launch 2 (raft_sparse.py:392-393: its
// heartbeats never travel): kernel KB then gives its heartbeats and acks no
// edge, and kernel KH does not process the slot.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SNAP_THREADS = 128;
constexpr int32_t NONE = -1;

// Launch 1. Grid (ceil(N / THREADS), B).
__global__ void __launch_bounds__(THREADS)
append_kernel(const uint32_t* __restrict__ seed, uint32_t r,
              const bool* __restrict__ lead, const int32_t* __restrict__ term,
              int32_t* __restrict__ log_term, int32_t* __restrict__ log_val,
              const int32_t* __restrict__ log_len,
              int32_t* __restrict__ len_out, int N, int L, int E) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= N) return;
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * N + j;
  const int32_t len = log_len[row];
  if (lead[row] && len < E) {
    // len < E <= L: the slot is inside the row.
    log_term[row * L + len] = term[row];
    log_val[row * L + len] = static_cast<int32_t>(ctt::random_u32(
        seed[b], ctt::STREAM_VALUE, r, 0u, static_cast<uint32_t>(j)));
    len_out[row] = len + 1;
  } else {
    len_out[row] = len;
  }
}

// Launch 2. A block per (sweep, slot).
template <bool WITHHOLD>
__global__ void __launch_bounds__(SNAP_THREADS)
snapshot_kernel(const bool* __restrict__ lead,
                const int32_t* __restrict__ term,
                const int32_t* __restrict__ log_term,
                const int32_t* __restrict__ log_val,
                const int32_t* __restrict__ len_out,
                const int32_t* __restrict__ commit,
                const int32_t* __restrict__ lead_id,
                bool* __restrict__ was_lead_k, int32_t* __restrict__ hb_ids,
                int32_t* __restrict__ s_term, int32_t* __restrict__ s_len,
                int32_t* __restrict__ s_commit, int32_t* __restrict__ s_logt,
                int32_t* __restrict__ s_logv, int N, int A, int L,
                int n_honest) {
  const int slot = blockIdx.x;  // b * A + a
  const int b = slot / A;
  const int32_t id = lead_id[slot];
  const long long node =
      static_cast<long long>(b) * N + min(max(id, 0), N - 1);
  if (threadIdx.x == 0) {
    const bool wl = id >= 0 && lead[node] && !(WITHHOLD && id >= n_honest);
    was_lead_k[slot] = wl;
    hb_ids[slot] = wl ? id : NONE;
    s_term[slot] = term[node];
    s_len[slot] = len_out[node];
    s_commit[slot] = commit[node];
  }
  const long long src = node * L, dst = static_cast<long long>(slot) * L;
  for (int k = threadIdx.x; k < L; k += SNAP_THREADS) {
    s_logt[dst + k] = log_term[src + k];
    s_logv[dst + k] = log_val[src + k];
  }
}

}  // namespace

extern "C" int ctt_propose(const uint32_t* seed, uint32_t r, const bool* lead,
                           const int32_t* term, int32_t* log_term,
                           int32_t* log_val, const int32_t* log_len,
                           const int32_t* commit, const int32_t* lead_id,
                           int32_t* len_out, bool* was_lead_k,
                           int32_t* hb_ids, int32_t* s_term, int32_t* s_len,
                           int32_t* s_commit, int32_t* s_logt,
                           int32_t* s_logv, int B, int N, int A, int L, int E,
                           int byz, int nb, cudaStream_t st) {
  if (A < 1 || E > L || nb < 0 || nb > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  append_kernel<<<dim3((N + THREADS - 1) / THREADS, B), THREADS, 0, st>>>(
      seed, r, lead, term, log_term, log_val, log_len, len_out, N, L, E);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const auto snapshot = byz == ctt::BYZ_SILENT ? snapshot_kernel<true>
                                               : snapshot_kernel<false>;
  snapshot<<<B * A, SNAP_THREADS, 0, st>>>(
      lead, term, log_term, log_val, len_out, commit, lead_id, was_lead_k,
      hb_ids, s_term, s_len, s_commit, s_logt, s_logv, N, A, L, N - nb);
  return static_cast<int>(cudaGetLastError());
}
