// Kernel KD: SPEC §3 P3c whole at every follower: the receiver side of the
// heartbeats (term catch-up, the choice of leader slot, timer and role),
// then the AppendEntries apply, updating the [B, N, L] logs in place.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round P3c
// (lines 398-435): t_in2, the highest snapshot term among the delivered
// heartbeats, bumps the follower (role follower, no vote, timeout redrawn
// under the new term); valid / lstar / kstar / has_l pick the delivered
// slot of the follower's term whose leader id is least; a follower that
// heard a leader resets its timer, and a candidate steps down. Then the
// log-match check at prev = s_next[k, j] - 1 and the copy of the chosen
// leader's entries [prev, s_len[k]) into the follower's row, with the
// one-hot helpers _rows_from_small, _pick1, _pick_row of the JAX package
// (which exist only to avoid the TPU's serial gather unit) turned into
// direct loads. The JAX round rewrites both [N, L] logs of every sweep
// each round (~820 MB at the flagship shape); this kernel writes only the
// copied words.
//
// Bound: bytes. Per follower it must read A bytes of the heartbeat mask,
// its term, role, vote, timer, timeout, reset, length and commit, one
// next-index byte, one word of its own log and of the leader's table, and
// write the copied words plus eleven outputs; in steady state a round
// copies at most a few words a row, so the least traffic is ~80 bytes a
// follower at A = 8 (64 MB at B = 8, N = 100 000), about 19 us at
// 3.35 TB/s. The timeout draw (~119 integer operations) runs only where a
// higher term arrives.
// Design: a lane per follower. Each lane runs the receiver prologue in
// registers (the sweep's A snapshot terms and leader ids are L1-resident),
// then evaluates its follower's apply scalars (coalesced loads, one
// dependent chain of loads per lane) and writes its outputs. A short copy
// range (the steady state: the newest entry or two) is copied by its own
// lane; the warp then walks the lanes with a long range (a ballot:
// followers catching up) and copies each such range with all 32 lanes, 32
// consecutive words at a time. The [A, L] leader tables are 8 KB a sweep
// at A = 8, L = 128, so their reads stay in L1/L2.
#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int32_t ROLE_F = 0, ROLE_C = 1, NONE = -1;
// Longest copy range a lane copies alone; longer ones take the whole warp.
constexpr int LANE_COPY = 4;

__global__ void __launch_bounds__(THREADS)
append_entries_kernel(const uint32_t* __restrict__ seed, int32_t t_min,
                      uint32_t t_span, const bool* __restrict__ del_lj,
                      const int32_t* __restrict__ lead_id,
                      const int32_t* __restrict__ s_term,
                      const int32_t* __restrict__ term,
                      const int32_t* __restrict__ role,
                      const int32_t* __restrict__ voted_for,
                      const int32_t* __restrict__ timer,
                      const int32_t* __restrict__ timeout,
                      const bool* __restrict__ reset,
                      int32_t* __restrict__ log_term,
                      int32_t* __restrict__ log_val,
                      const int32_t* __restrict__ log_len,
                      const int32_t* __restrict__ commit,
                      const uint8_t* __restrict__ s_next,
                      const int32_t* __restrict__ s_len,
                      const int32_t* __restrict__ s_commit,
                      const int32_t* __restrict__ s_logt,
                      const int32_t* __restrict__ s_logv,
                      int32_t* __restrict__ term_out,
                      int32_t* __restrict__ role_out,
                      int32_t* __restrict__ vf_out,
                      int32_t* __restrict__ timer_out,
                      int32_t* __restrict__ timeout_out,
                      bool* __restrict__ reset_out,
                      int32_t* __restrict__ kstar_out,
                      bool* __restrict__ has_l_out,
                      bool* __restrict__ apply_out,
                      int32_t* __restrict__ len_out,
                      int32_t* __restrict__ commit_out, int B, int N, int A,
                      int L) {
  // Every lane stays to the end: the copy phase shuffles across the warp.
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long slot = 0;
  int begin = 0, end = 0;
  if (row < static_cast<long long>(B) * N) {
    const int b = static_cast<int>(row / N);
    const int j = static_cast<int>(row - static_cast<long long>(b) * N);
    const long long slots = static_cast<long long>(b) * A;
    // Receiver prologue. t_in2: the highest delivered snapshot term.
    const bool* hb = del_lj + slots * N + j;
    int32_t t_in2 = 0;
    for (int a = 0; a < A; ++a)
      if (hb[static_cast<long long>(a) * N])
        t_in2 = max(t_in2, s_term[slots + a]);
    int32_t tm = term[row], rl = role[row], vf = voted_for[row];
    int32_t tmr = timer[row], to = timeout[row];
    bool rs = reset[row];
    if (t_in2 > tm) {
      tm = t_in2;
      rl = ROLE_F;
      vf = NONE;
      to = ctt::draw_timeout(seed[b], tm, j, t_min, t_span);
    }
    // The delivered slot of the follower's term with the least leader id
    // (the first such slot on ties, as argmin; slot 0 when there is none).
    int32_t lstar = N;
    int k = 0;
    for (int a = 0; a < A; ++a) {
      if (hb[static_cast<long long>(a) * N] && s_term[slots + a] == tm) {
        const int32_t lid = min(max(lead_id[slots + a], 0), N - 1);
        if (lid < lstar) {
          lstar = lid;
          k = a;
        }
      }
    }
    const bool has_l = lstar < N;
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
    kstar_out[row] = k;
    has_l_out[row] = has_l;
    // The apply.
    const int32_t len = log_len[row];
    const int32_t com = commit[row];
    bool apply = false;
    int32_t new_len = len, new_commit = com;
    if (has_l) {
      slot = slots + k;
      const int prev = static_cast<int>(s_next[slot * N + j]) - 1;
      const int kprev = min(max(prev - 1, 0), L - 1);
      const int32_t prev_term_l = prev > 0 ? s_logt[slot * L + kprev] : 0;
      const int32_t own_at_prev =
          (prev > 0 && prev <= len) ? log_term[row * L + kprev] : 0;
      apply = prev == 0 || (prev <= len && own_at_prev == prev_term_l);
      if (apply) {
        new_len = s_len[slot];
        new_commit = max(com, min(s_commit[slot], new_len));
        begin = max(prev, 0);
        end = min(new_len, L);
      }
    }
    apply_out[row] = apply;
    len_out[row] = new_len;
    commit_out[row] = new_commit;
  }
  // Copy phase. A row reads its own log only at prev - 1 < begin, before
  // this phase, and no two lanes share a row.
  const bool wide = end - begin > LANE_COPY;
  if (!wide) {
    for (int k = begin; k < end; ++k) {
      log_term[row * L + k] = s_logt[slot * L + k];
      log_val[row * L + k] = s_logv[slot * L + k];
    }
  }
  unsigned pending = __ballot_sync(0xFFFFFFFFu, wide);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const long long r = __shfl_sync(0xFFFFFFFFu, row, src);
    const long long s = __shfl_sync(0xFFFFFFFFu, slot, src);
    const int lo = __shfl_sync(0xFFFFFFFFu, begin, src);
    const int hi = __shfl_sync(0xFFFFFFFFu, end, src);
    for (int k = lo + lane; k < hi; k += 32) {
      log_term[r * L + k] = s_logt[s * L + k];
      log_val[r * L + k] = s_logv[s * L + k];
    }
  }
}

}  // namespace

extern "C" int ctt_append_entries(
    const uint32_t* seed, int32_t t_min, uint32_t t_span,
    const bool* del_lj, const int32_t* lead_id, const int32_t* s_term,
    const int32_t* term, const int32_t* role, const int32_t* voted_for,
    const int32_t* timer, const int32_t* timeout, const bool* reset,
    int32_t* log_term, int32_t* log_val, const int32_t* log_len,
    const int32_t* commit, const uint8_t* s_next, const int32_t* s_len,
    const int32_t* s_commit, const int32_t* s_logt, const int32_t* s_logv,
    int32_t* term_out, int32_t* role_out, int32_t* vf_out,
    int32_t* timer_out, int32_t* timeout_out, bool* reset_out,
    int32_t* kstar_out, bool* has_l_out, bool* apply_out, int32_t* len_out,
    int32_t* commit_out, int B, int N, int A, int L, cudaStream_t st) {
  if (A < 1 || t_span == 0u) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * N;
  if (rows == 0) return 0;
  const long long blocks = (rows + THREADS - 1) / THREADS;
  append_entries_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      seed, t_min, t_span, del_lj, lead_id, s_term, term, role, voted_for,
      timer, timeout, reset, log_term, log_val, log_len, commit, s_next,
      s_len, s_commit, s_logt, s_logv, term_out, role_out, vf_out, timer_out,
      timeout_out, reset_out, kstar_out, has_l_out, apply_out, len_out,
      commit_out, B, N, A, L);
  return static_cast<int>(cudaGetLastError());
}
