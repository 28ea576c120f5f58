// Kernel KN: SPEC §3 P3a propose, P3b snapshot and P3c receivers of the
// dense Raft round at every node of each sweep, updating the [B, N, L]
// logs in place.
//
// Replaces: consensus_tpu/engines/raft.py raft_round (K14) lines 422-478 on
// its flat path: P3a (a leader whose log holds fewer than E entries writes
// (term, value) at its log length, the value a Threefry draw of
// STREAM_VALUE keyed by (round, node), grows its log by one and matches
// itself there), P3b (the leaders' term, length, commit and log rows that
// P3c reads) and P3c (t_in2, the highest delivered leader term, bumps the
// receiver; of the delivered leaders of the receiver's term the least id
// is its leader; the timer resets and a candidate steps down; the
// log-match check at prev = next_idx[leader, j] - 1, the copy of the
// leader's entries [prev, its length), the new length and the commit
// following the leader's), with the one-hot helpers _pick1 / _pick_row of
// the JAX package (which exist only to avoid the TPU's serial gather unit)
// turned into direct loads.
//
// The snapshot matters: a stale leader that a higher-term heartbeat bumps
// in P3c is at once a sender, whose row, length, commit and term other
// receivers read as they were after P3a, and a receiver that may
// overwrite its own row, length and term. So the leaders' scalars are
// copied into a table in launch 1 and their rows in launch 2, and P3c
// reads only those copies of any other node.
//
// Bound: bytes. Per node it reads eight i32 words and a flag and writes
// nine words and three flags (about 70 bytes); per (leader, receiver) pair
// one mask byte; per receiver with a leader one next_idx byte and two log
// words for the match check; per appending leader two log words and a
// match byte; per copied entry two words read and two written. At
// raft-1kx1k (B = 8, N = 1024) in steady state (one leader a sweep, one
// new entry a receiver) that is about 0.7 MB, a fraction of a microsecond
// at 3.35 TB/s: the kernel is set by its launches' latency.
// Design: three launches on the stream.
//  1. A thread per node: P3a in registers (the value drawn inline), the
//     new length, and, for a leader, its entry in its sweep's leader table
//     (id, term, length, commit; 16 bytes) at a place an atomic gives.
//  2. A block per sweep copies each listed leader's two rows, after the
//     append, into row scratch at the leader's place in the table.
//  3. A lane per receiver walks its sweep's table once (the mask bytes
//     deliver[l, j] of consecutive j are coalesced), keeping the highest
//     delivered term and the least delivered id of that term; a leader is
//     valid exactly when its term is the receiver's after the bump. Then
//     the apply's scalars; a short copy range is copied by its own lane,
//     and the warp copies each long one (a follower catching up) 32 words
//     at a time, as kernel KD does.
// Its CRASH instance (SPEC §6c, picked when the round's flag word of kernel
// KAH is given) changes launch 1 only: a leader down at the round's end
// neither appends nor is listed (its log and rows stay frozen, and KL cut
// its heartbeats); launch 3 then leaves a down node as it is, since KL cut
// every heartbeat to it.
// Its BYZ instance (SPEC §3c, picked with silent byzantine nodes: the ids
// N - nb and up) changes launch 1 only: a silent byzantine leader appends
// (P3a) but is neither listed nor a was_leader, since its heartbeats never
// travel (raft.py:435); KO then processes no acks for it.
#include <climits>

#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int32_t ROLE_F = 0, ROLE_C = 1, ROLE_L = 2, NONE = -1;
// Longest copy range a lane copies alone; longer ones take the whole warp.
constexpr int LANE_COPY = 4;

// Launch 1. A thread per (sweep, node), flattened.
template <bool CRASH, bool WITHHOLD>
__global__ void __launch_bounds__(THREADS)
dense_propose_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                     const int32_t* __restrict__ term,
                     const int32_t* __restrict__ role,
                     int32_t* __restrict__ log_term,
                     int32_t* __restrict__ log_val,
                     const int32_t* __restrict__ log_len,
                     const int32_t* __restrict__ commit,
                     uint8_t* __restrict__ match_idx,
                     int32_t* __restrict__ len_out,
                     bool* __restrict__ was_leader, int4* __restrict__ leaders,
                     int* __restrict__ n_lead,
                     const unsigned char* __restrict__ flags, int N, int L,
                     int E, long long rows, int n_honest) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  const int i = static_cast<int>(row - static_cast<long long>(b) * N);
  const bool lead = role[row] == ROLE_L &&
                    !(CRASH && (flags[row] & ctt::CRASH_DOWN));
  const int32_t tm = term[row];
  int32_t len = log_len[row];
  if (lead && len < E) {
    // len < E <= L: the slot is inside the row.
    log_term[row * L + len] = tm;
    log_val[row * L + len] = static_cast<int32_t>(ctt::random_u32(
        seed[b], ctt::STREAM_VALUE, r, 0u, static_cast<uint32_t>(i)));
    ++len;
    match_idx[row * N + i] = static_cast<uint8_t>(len);
  }
  len_out[row] = len;
  const bool sends = lead && !(WITHHOLD && i >= n_honest);
  was_leader[row] = sends;
  if (sends) {
    const int q = atomicAdd(&n_lead[b], 1);
    leaders[static_cast<long long>(b) * N + q] =
        make_int4(i, tm, len, commit[row]);
  }
}

// Launch 2. A block per sweep.
__global__ void __launch_bounds__(THREADS)
dense_snapshot_kernel(const int32_t* __restrict__ log_term,
                      const int32_t* __restrict__ log_val,
                      const int4* __restrict__ leaders,
                      const int* __restrict__ n_lead,
                      int32_t* __restrict__ snap_t,
                      int32_t* __restrict__ snap_v,
                      int N, int L) {
  const int b = blockIdx.x;
  const long long nodes = static_cast<long long>(b) * N;
  const int nl = n_lead[b];
  for (int q = 0; q < nl; ++q) {
    const long long src = (nodes + leaders[nodes + q].x) * L;
    const long long dst = (nodes + q) * L;
    for (int k = threadIdx.x; k < L; k += THREADS) {
      snap_t[dst + k] = log_term[src + k];
      snap_v[dst + k] = log_val[src + k];
    }
  }
}

// Launch 3. A lane per (sweep, receiver), flattened; every lane stays to
// the end, since the copy phase shuffles across the warp.
__global__ void __launch_bounds__(THREADS)
dense_receivers_kernel(const uint32_t* __restrict__ seed, int32_t t_min,
                       uint32_t t_span, const bool* __restrict__ deliver,
                       const int32_t* __restrict__ term,
                       const int32_t* __restrict__ role,
                       const int32_t* __restrict__ voted_for,
                       const int32_t* __restrict__ timer,
                       const int32_t* __restrict__ timeout,
                       const bool* __restrict__ reset,
                       int32_t* __restrict__ log_term,
                       int32_t* __restrict__ log_val,
                       const int32_t* __restrict__ commit,
                       const uint8_t* __restrict__ next_idx,
                       const int4* __restrict__ leaders,
                       const int* __restrict__ n_lead,
                       const int32_t* __restrict__ snap_t,
                       const int32_t* __restrict__ snap_v,
                       int32_t* __restrict__ term_out,
                       int32_t* __restrict__ role_out,
                       int32_t* __restrict__ vf_out,
                       int32_t* __restrict__ timer_out,
                       int32_t* __restrict__ timeout_out,
                       bool* __restrict__ reset_out,
                       int32_t* __restrict__ len_out,
                       int32_t* __restrict__ commit_out,
                       int32_t* __restrict__ ack_to, bool* __restrict__ ack_ok,
                       int32_t* __restrict__ ack_match, int N, int L,
                       long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long src = 0;  // the leader's snapshot row
  int begin = 0, end = 0;
  if (row < rows) {
    const int b = static_cast<int>(row / N);
    const int j = static_cast<int>(row - static_cast<long long>(b) * N);
    const long long nodes = static_cast<long long>(b) * N;
    const int4* table = leaders + nodes;
    const int nl = n_lead[b];
    // One pass: the highest delivered leader term `top`, and the least
    // delivered leader id of that term with its table place.
    bool any = false;
    int32_t top = INT_MIN, lstar = N;
    int qstar = 0;
    for (int q = 0; q < nl; ++q) {
      const int4 l = table[q];  // id, term, length, commit
      if (!deliver[(nodes + l.x) * N + j]) continue;
      if (!any || l.y > top) {
        any = true;
        top = l.y;
        lstar = N;
      }
      if (l.y == top && l.x < lstar) {
        lstar = l.x;
        qstar = q;
      }
    }
    int32_t tm = term[row], rl = role[row], vf = voted_for[row];
    int32_t tmr = timer[row], to = timeout[row];
    bool rs = reset[row];
    const int32_t t_in2 = any ? max(top, 0) : 0;
    if (t_in2 > tm) {
      tm = t_in2;
      rl = ROLE_F;
      vf = NONE;
      to = ctt::draw_timeout(seed[b], tm, j, t_min, t_span);
    }
    const bool has_l = any && top == tm;
    if (has_l) {
      tmr = 0;
      rs = true;
      if (rl == ROLE_C) rl = ROLE_F;
    }
    term_out[row] = tm;
    role_out[row] = rl;
    vf_out[row] = vf;
    timer_out[row] = tmr;
    timeout_out[row] = to;
    reset_out[row] = rs;
    ack_to[row] = has_l ? lstar : NONE;
    // The apply, against the receiver's post-P3a log.
    const int32_t len = len_out[row];
    const int32_t com = commit[row];
    bool apply = false;
    int32_t new_len = len, new_commit = com;
    if (has_l) {
      const int4 l = table[qstar];
      src = (nodes + qstar) * L;
      const int prev =
          static_cast<int>(next_idx[(nodes + lstar) * N + j]) - 1;
      const int kprev = min(max(prev - 1, 0), L - 1);
      const int32_t prev_term_l = prev > 0 ? snap_t[src + kprev] : 0;
      const int32_t own_at_prev =
          (prev > 0 && prev <= len) ? log_term[row * L + kprev] : 0;
      apply = prev == 0 || (prev <= len && own_at_prev == prev_term_l);
      if (apply) {
        new_len = l.z;
        new_commit = max(com, min(l.w, new_len));
        begin = max(prev, 0);
        end = min(new_len, L);
      }
    }
    ack_ok[row] = apply;
    ack_match[row] = apply ? new_len : 0;
    len_out[row] = new_len;
    commit_out[row] = new_commit;
  }
  // Copy phase. A receiver reads its own row only at prev - 1 < begin,
  // before this phase, and no two lanes share a row; the sources are the
  // snapshot rows, which nothing writes here.
  const bool wide = end - begin > LANE_COPY;
  if (!wide) {
    for (int k = begin; k < end; ++k) {
      log_term[row * L + k] = snap_t[src + k];
      log_val[row * L + k] = snap_v[src + k];
    }
  }
  unsigned pending = __ballot_sync(0xFFFFFFFFu, wide);
  while (pending) {
    const int from = __ffs(pending) - 1;
    pending &= pending - 1;
    const long long dst = __shfl_sync(0xFFFFFFFFu, row, from) * L;
    const long long s = __shfl_sync(0xFFFFFFFFu, src, from);
    const int lo = __shfl_sync(0xFFFFFFFFu, begin, from);
    const int hi = __shfl_sync(0xFFFFFFFFu, end, from);
    for (int k = lo + lane; k < hi; k += 32) {
      log_term[dst + k] = snap_t[s + k];
      log_val[dst + k] = snap_v[s + k];
    }
  }
}

}  // namespace

extern "C" int ctt_dense_append(
    const uint32_t* seed, uint32_t r, int32_t t_min, uint32_t t_span,
    const bool* deliver, const int32_t* term, const int32_t* role,
    const int32_t* voted_for, const int32_t* timer, const int32_t* timeout,
    const bool* reset, int32_t* log_term, int32_t* log_val,
    const int32_t* log_len, const int32_t* commit, uint8_t* match_idx,
    const uint8_t* next_idx, int32_t* term_out, int32_t* role_out,
    int32_t* vf_out, int32_t* timer_out, int32_t* timeout_out,
    bool* reset_out, int32_t* len_out, int32_t* commit_out,
    bool* was_leader, int32_t* ack_to, bool* ack_ok, int32_t* ack_match,
    int32_t* scratch, int32_t* snap, const unsigned char* flags, int B,
    int N, int L, int E, int byz, int nb, cudaStream_t st) {
  if (t_span == 0u || E > L || nb < 0 || nb > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long rows = static_cast<long long>(B) * N;
  // Scratch: the leader tables [B, N] int4 first (16-byte aligned), then
  // the counts [B] (zeroed here); snap holds the leaders' term rows
  // [B, N, L], then their value rows.
  int4* leaders = reinterpret_cast<int4*>(scratch);
  int* n_lead = scratch + 4 * rows;
  int32_t* snap_t = snap;
  int32_t* snap_v = snap + rows * L;
  int err = static_cast<int>(cudaMemsetAsync(n_lead, 0, sizeof(int) * B, st));
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>((rows + THREADS - 1) / THREADS);
  const bool crash = flags != nullptr, withhold = byz == ctt::BYZ_SILENT;
  const auto propose =
      crash ? (withhold ? dense_propose_kernel<true, true>
                        : dense_propose_kernel<true, false>)
            : (withhold ? dense_propose_kernel<false, true>
                        : dense_propose_kernel<false, false>);
  propose<<<blocks, THREADS, 0, st>>>(
      seed, r, term, role, log_term, log_val, log_len, commit, match_idx,
      len_out, was_leader, leaders, n_lead, flags, N, L, E, rows, N - nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  dense_snapshot_kernel<<<B, THREADS, 0, st>>>(log_term, log_val, leaders,
                                               n_lead, snap_t, snap_v, N, L);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  dense_receivers_kernel<<<blocks, THREADS, 0, st>>>(
      seed, t_min, t_span, deliver, term, role, voted_for, timer, timeout,
      reset, log_term, log_val, commit, next_idx, leaders, n_lead, snap_t,
      snap_v, term_out, role_out, vf_out, timer_out, timeout_out, reset_out,
      len_out, commit_out, ack_to, ack_ok, ack_match, N, L, rows);
  return static_cast<int>(cudaGetLastError());
}
