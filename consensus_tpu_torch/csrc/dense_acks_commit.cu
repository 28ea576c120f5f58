// Kernel KO: SPEC §3 P3d acks, P3e majority commit and P4 timers of the
// dense Raft round at every node of each sweep, updating the round's state
// in place.
//
// Replaces: consensus_tpu/engines/raft.py raft_round (K14) lines 480-525 on
// its flat path: P3d (node j's ack to ack_to[j] travels on deliver[j, l];
// a P3b sender that still leads takes the highest acked term and is bumped
// by a higher one, otherwise it processes its acks: a success raises
// match_idx[l, j] to the acked length and sets next_idx[l, j] one past it,
// a failure steps next_idx[l, j] back, not below 1, in u8 arithmetic), P3e
// (the majority-th largest entry of each processing leader's match_idx
// row, found in JAX by a fixed-depth binary search over [0, E + 1), and
// the commit advance where the leader's post-P3c log holds an entry of its
// own term there) and P4 (leaders hold their timer at 0, other nodes count
// it up unless the round reset it).
//
// Bound: bytes. Per node it reads its ack target, term, role, sender flag
// and reset flag and reads and writes its timer (about 18 bytes); per ack
// one mask byte, and per ack to a processing leader the ack fields and a
// match and next byte; per processing leader one [N] match row for the
// median. At raft-1kx1k (B = 8, N = 1024) with one leader a sweep that is
// about 0.2 MB, well under a microsecond at 3.35 TB/s: the kernel is set
// by its launches' latency.
// Design: four launches on the stream.
//  1. A thread per node takes its delivered ack's term into its leader's
//     maximum with one global atomicMax.
//  2. A thread per node: a sender that still leads is bumped by a higher
//     acked term (role follower, no vote, timeout redrawn inline), or is
//     flagged as processing and listed in its sweep's processing list.
//  3. A thread per node applies its ack to its leader's match/next entry
//     (each entry has one writer: column j is node j's), then runs P4 on
//     the roles launch 2 settled.
//  4. A block per sweep walks its processing leaders: a 256-bin histogram
//     of the leader's match row in shared memory, its suffix sums, and the
//     largest m <= E whose suffix count reaches the majority, which is
//     what the binary search returns; then the commit advance.
// Its CRASH instance (SPEC §6c, picked when the round's flag word of kernel
// KAH is given) changes launch 3 only: a node down at the round's end keeps
// its timer (the freeze, raft.py:527-536). KL cut every ack to or from a
// down node and KN listed no down leader, so nothing else reaches it.
// Its BYZ instance (SPEC §3c, picked with silent byzantine nodes: the ids
// N - nb and up) leaves their acks out of launches 1 and 3: they never
// travel (raft.py:483-484); their timers still count in launch 3. KN
// marked no silent byzantine leader a sender, so none is processed.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BINS = 256;
constexpr int32_t ROLE_F = 0, ROLE_L = 2, NONE = -1;

// Launch 1. A thread per (sweep, node), flattened.
template <bool WITHHOLD>
__global__ void __launch_bounds__(THREADS)
dense_ack_term_kernel(const bool* __restrict__ deliver,
                      const int32_t* __restrict__ ack_to,
                      const int32_t* __restrict__ term, int* __restrict__ t_in3,
                      int N, long long rows, int n_honest) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  if (WITHHOLD && static_cast<int>(row % N) >= n_honest) return;
  const int32_t l = ack_to[row];
  if (l < 0 || l >= N || !deliver[row * N + l]) return;
  const int32_t t = term[row];
  const long long nodes = row - row % N;
  if (t > 0) atomicMax(&t_in3[nodes + l], t);  // the maximum starts at 0
}

// Launch 2. A thread per (sweep, node), flattened.
__global__ void __launch_bounds__(THREADS)
dense_bump_kernel(const uint32_t* __restrict__ seed, int32_t t_min,
                  uint32_t t_span, const bool* __restrict__ was_leader,
                  const int* __restrict__ t_in3, int32_t* __restrict__ term,
                  int32_t* __restrict__ role, int32_t* __restrict__ voted_for,
                  int32_t* __restrict__ timeout, int* __restrict__ proc,
                  int* __restrict__ n_proc, int* __restrict__ proc_list, int N,
                  long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int l = static_cast<int>(row - static_cast<long long>(b) * N);
  const bool still = was_leader[row] && role[row] == ROLE_L;
  const int32_t t3 = t_in3[row];
  const bool bumped = still && t3 > term[row];
  if (bumped) {
    term[row] = t3;
    role[row] = ROLE_F;
    voted_for[row] = NONE;
    timeout[row] = ctt::draw_timeout(seed[b], t3, l, t_min, t_span);
  }
  const bool p = still && !bumped;
  proc[row] = p;
  if (p) {
    const int q = atomicAdd(&n_proc[b], 1);
    proc_list[static_cast<long long>(b) * N + q] = l;
  }
}

// Launch 3. A thread per (sweep, node), flattened.
template <bool CRASH, bool WITHHOLD>
__global__ void __launch_bounds__(THREADS)
dense_match_timer_kernel(const bool* __restrict__ deliver,
                         const int32_t* __restrict__ ack_to,
                         const bool* __restrict__ ack_ok,
                         const int32_t* __restrict__ ack_match,
                         const int* __restrict__ proc,
                         const int32_t* __restrict__ role,
                         const bool* __restrict__ reset,
                         uint8_t* __restrict__ match_idx,
                         uint8_t* __restrict__ next_idx,
                         int32_t* __restrict__ timer,
                         const unsigned char* __restrict__ flags, int N,
                         long long rows, int n_honest) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const long long nodes = row - row % N;
  const int j = static_cast<int>(row - nodes);
  const int32_t l = ack_to[row];
  if (!(WITHHOLD && j >= n_honest) && l >= 0 && l < N &&
      deliver[row * N + l] && proc[nodes + l]) {
    const long long e = (nodes + l) * N + j;
    if (ack_ok[row]) {
      const uint8_t acked = static_cast<uint8_t>(ack_match[row]);
      const uint8_t m = match_idx[e] > acked ? match_idx[e] : acked;
      match_idx[e] = m;
      next_idx[e] = static_cast<uint8_t>(m + 1);
    } else {
      const uint8_t dec = static_cast<uint8_t>(next_idx[e] - 1);
      next_idx[e] = dec > 1 ? dec : 1;
    }
  }
  // P4.
  if (CRASH && (flags[row] & ctt::CRASH_DOWN)) return;
  if (role[row] == ROLE_L)
    timer[row] = 0;
  else if (!reset[row])  // wraps as the plain version's i32 add
    timer[row] = static_cast<int32_t>(static_cast<uint32_t>(timer[row]) + 1u);
}

// Launch 4. A block of BINS threads per sweep.
__global__ void __launch_bounds__(BINS)
dense_commit_kernel(const int* __restrict__ n_proc,
                    const int* __restrict__ proc_list,
                    const uint8_t* __restrict__ match_idx,
                    const int32_t* __restrict__ log_term,
                    const int32_t* __restrict__ term,
                    int32_t* __restrict__ commit,
                    int N, int L, int E) {
  __shared__ unsigned s_suf[BINS];
  __shared__ int s_med;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long nodes = static_cast<long long>(b) * N;
  const unsigned majority = static_cast<unsigned>(N / 2 + 1);
  const int np = n_proc[b];
  for (int q = 0; q < np; ++q) {  // uniform in the block
    const int l = proc_list[nodes + q];
    const uint8_t* m = match_idx + (nodes + l) * N;
    s_suf[t] = 0u;
    __syncthreads();
    for (int k = t; k < N; k += BINS) atomicAdd(&s_suf[m[k]], 1u);
    __syncthreads();
    // Suffix sums: s_suf[v] = entries >= v.
    for (int off = 1; off < BINS; off <<= 1) {
      const unsigned above = t + off < BINS ? s_suf[t + off] : 0u;
      __syncthreads();
      s_suf[t] += above;
      __syncthreads();
    }
    // s_suf[0] = N reaches the majority, and the sums fall with v: one
    // v <= E is the last to reach it.
    if (t <= E && s_suf[t] >= majority && (t == E || s_suf[t + 1] < majority))
      s_med = t;
    __syncthreads();
    if (t == 0) {
      const int med = s_med;
      const long long row = nodes + l;
      const int kmed = min(max(med - 1, 0), L - 1);
      if (med > 0 && med > commit[row] &&
          log_term[row * L + kmed] == term[row])
        commit[row] = med;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ctt_dense_acks_commit(
    const uint32_t* seed, int32_t t_min, uint32_t t_span,
    const bool* deliver, const bool* was_leader, const int32_t* ack_to,
    const bool* ack_ok, const int32_t* ack_match, const int32_t* log_term,
    int32_t* term, int32_t* role, int32_t* voted_for, int32_t* timeout,
    int32_t* commit, uint8_t* match_idx, uint8_t* next_idx, int32_t* timer,
    const bool* reset, int32_t* scratch, const unsigned char* flags, int B,
    int N, int L, int E, int byz, int nb, cudaStream_t st) {
  if (t_span == 0u || E < 0 || E >= BINS || E > L || nb < 0 || nb > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long rows = static_cast<long long>(B) * N;
  // Scratch: the ack-term maxima [B, N] and the processing counts [B]
  // (zeroed here), the processing flags [B, N] and lists [B, N].
  int* t_in3 = scratch;
  int* n_proc = t_in3 + rows;
  int* proc = n_proc + B;
  int* proc_list = proc + rows;
  int err = static_cast<int>(
      cudaMemsetAsync(t_in3, 0, sizeof(int) * (rows + B), st));
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>((rows + THREADS - 1) / THREADS);
  const bool withhold = byz == ctt::BYZ_SILENT;
  const auto ack_term = withhold ? dense_ack_term_kernel<true>
                                 : dense_ack_term_kernel<false>;
  ack_term<<<blocks, THREADS, 0, st>>>(deliver, ack_to, term, t_in3, N, rows,
                                       N - nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  dense_bump_kernel<<<blocks, THREADS, 0, st>>>(
      seed, t_min, t_span, was_leader, t_in3, term, role, voted_for, timeout,
      proc, n_proc, proc_list, N, rows);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const bool crash = flags != nullptr;
  const auto match_timer =
      crash ? (withhold ? dense_match_timer_kernel<true, true>
                        : dense_match_timer_kernel<true, false>)
            : (withhold ? dense_match_timer_kernel<false, true>
                        : dense_match_timer_kernel<false, false>);
  match_timer<<<blocks, THREADS, 0, st>>>(
      deliver, ack_to, ack_ok, ack_match, proc, role, reset, match_idx,
      next_idx, timer, flags, N, rows, N - nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  dense_commit_kernel<<<B, BINS, 0, st>>>(n_proc, proc_list, match_idx,
                                          log_term, term, commit, N, L, E);
  return static_cast<int>(cudaGetLastError());
}
