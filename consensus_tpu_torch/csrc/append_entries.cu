// Kernel KD: SPEC §3 P3c, the AppendEntries apply step at every follower,
// updating the [B, N, L] logs in place.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round P3c
// (lines 415-435): the log-match check at prev = s_next[k, j] - 1 and the
// copy of the chosen leader's entries [prev, s_len[k]) into the follower's
// row, with the one-hot helpers _rows_from_small, _pick1, _pick_row of the
// JAX package (which exist only to avoid the TPU's serial gather unit)
// turned into direct loads. The JAX round rewrites both [N, L] logs of every
// sweep each round (~820 MB at the flagship shape); this kernel writes only
// the copied words.
//
// Bound: bytes. Per follower it must read its slot, flag, length, commit and
// one next-index byte, one word of its own log and of the leader's table,
// and write the copied words plus three outputs; in steady state a round
// copies at most a few words a row, so the least traffic is ~20 bytes a
// follower (16 MB at B = 8, N = 100 000), about 5 us at 3.35 TB/s.
// Design: a lane per follower. Each lane evaluates its follower's scalars
// (coalesced loads, one dependent chain of loads per lane) and writes its
// three outputs. A short copy range (the steady state: the newest entry or
// two) is copied by its own lane; the warp then walks the lanes with a long
// range (a ballot: followers catching up) and copies each such range with
// all 32 lanes, 32 consecutive words at a time. The [A, L] leader tables
// are 8 KB a sweep at A = 8, L = 128, so their reads stay in L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// Longest copy range a lane copies alone; longer ones take the whole warp.
constexpr int LANE_COPY = 4;

__global__ void __launch_bounds__(THREADS)
append_entries_kernel(int32_t* __restrict__ log_term,
                      int32_t* __restrict__ log_val,
                      const int32_t* __restrict__ log_len,
                      const int32_t* __restrict__ commit,
                      const int32_t* __restrict__ kstar,
                      const bool* __restrict__ has_l,
                      const uint8_t* __restrict__ s_next,
                      const int32_t* __restrict__ s_len,
                      const int32_t* __restrict__ s_commit,
                      const int32_t* __restrict__ s_logt,
                      const int32_t* __restrict__ s_logv,
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
    const int32_t len = log_len[row];
    const int32_t com = commit[row];
    bool apply = false;
    int32_t new_len = len, new_commit = com;
    if (has_l[row]) {
      slot = static_cast<long long>(b) * A + kstar[row];
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

extern "C" int ctt_append_entries(int32_t* log_term, int32_t* log_val,
                                  const int32_t* log_len,
                                  const int32_t* commit, const int32_t* kstar,
                                  const bool* has_l, const uint8_t* s_next,
                                  const int32_t* s_len,
                                  const int32_t* s_commit,
                                  const int32_t* s_logt,
                                  const int32_t* s_logv, bool* apply_out,
                                  int32_t* len_out, int32_t* commit_out,
                                  int B, int N, int A, int L,
                                  cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * N;
  if (rows == 0) return 0;
  const long long blocks = (rows + THREADS - 1) / THREADS;
  append_entries_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      log_term, log_val, log_len, commit, kstar, has_l, s_next, s_len,
      s_commit, s_logt, s_logv, apply_out, len_out, commit_out, B, N, A, L);
  return static_cast<int>(cudaGetLastError());
}
