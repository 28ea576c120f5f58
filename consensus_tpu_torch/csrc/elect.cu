// Kernel KF: SPEC §3 P2, the election over the sweep's active candidates
// (at most A, ranked by kernel KC), at every node of each sweep.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round P2
// (lines 255-352, the flat path): P2a term catch-up (a max over the
// delivered requests, then the bump with the timeout redrawn under the new
// term), P2b grants (re-grant to voted_for if eligible, else the least
// eligible candidate id), P2c the tally of delivered grants per candidate
// and the winners' promotion to leader. The request and response masks
// [B, A, N] and [B, N, A] come from kernel KB. It also writes the
// role == leader mask that kernel KC ranks and kernel KI reads (the JAX
// round's `lead`, line 378) and the [B, A] winner flags that kernel KK
// counts (`win`, line 348), so neither costs a launch of its own.
//
// Bound: bytes. Per node it reads seven i32 words, one flag and A bytes of
// each mask, and writes five i32 words and two flags: 67 bytes at A = 8,
// 54 MB at the flagship shape (B = 8, N = 100 000), about 16 us at
// 3.35 TB/s. The vote tally is one shared-memory atomic per granting node
// and at most A global atomics per block.
// Design: two launches. Launch 1, a thread per node on a (node, sweep)
// grid: each block first loads the sweep's candidate table (ids, clamped
// ids, request term, last index, last term) into shared memory from the
// inputs, which no thread writes: every output is a fresh buffer, so the
// candidates' fields are always read as they entered P2 while other
// blocks already bump terms. Integer atomics make the tally independent of
// order. Launch 2, a thread per (sweep, candidate): a valid candidate that
// is still a candidate after P2a (read from the outputs) and holds a
// majority becomes leader; every slot writes its winner flag. Its CRASH
// instance (SPEC §6c, picked when the round's flag word of kernel KAH is
// given) leaves the nodes down at the round's end out of the leader mask
// (raft_sparse.py:359-360): KC then never tracks them and KI appends
// nothing to their logs. A down node's state passes through unchanged,
// since KB cut every request and response it would see or send, and the
// candidates (KC's, from KE's mask) are up.
// Its BYZ instances (SPEC §3c, picked with byzantine nodes; their ids are
// N - nb and up) change P2c only: a silent node's vote response never
// travels (raft_sparse.py:342), and an equivocating node's response reaches
// every valid candidate whose request it got and whose way back is open
// (del_cj[a, j] & del_jc[j, a], lines 343-346), whatever it granted. Its
// own P2a and P2b run as an honest node's.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXA = 16;
constexpr int32_t ROLE_F = 0, ROLE_C = 1, ROLE_L = 2, NONE = -1;

template <bool CRASH, int BYZ>
__global__ void __launch_bounds__(THREADS)
elect_nodes_kernel(const uint32_t* __restrict__ seed, int32_t t_min,
                   uint32_t t_span, const int32_t* __restrict__ cand_ids,
                   const bool* __restrict__ del_cj,
                   const bool* __restrict__ del_jc,
                   const int32_t* __restrict__ term,
                   const int32_t* __restrict__ role,
                   const int32_t* __restrict__ voted_for,
                   const int32_t* __restrict__ timer,
                   const int32_t* __restrict__ timeout,
                   const bool* __restrict__ reset,
                   const int32_t* __restrict__ log_len,
                   const int32_t* __restrict__ own_lterm,
                   int32_t* __restrict__ term_out,
                   int32_t* __restrict__ role_out,
                   int32_t* __restrict__ vf_out,
                   int32_t* __restrict__ timer_out,
                   int32_t* __restrict__ timeout_out,
                   bool* __restrict__ reset_out,
                   bool* __restrict__ lead_out, int* __restrict__ votes,
                   const unsigned char* __restrict__ flags, int N, int A,
                   int n_honest) {
  __shared__ int32_t s_id[MAXA], s_cid[MAXA], s_rterm[MAXA], s_rlidx[MAXA],
      s_rlterm[MAXA];
  __shared__ int s_votes[MAXA];
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * N;
  if (threadIdx.x < A) {
    const int a = threadIdx.x;
    const int32_t id = cand_ids[b * A + a];
    const int32_t cid = min(max(id, 0), N - 1);
    s_id[a] = id;
    s_cid[a] = cid;
    s_rterm[a] = id >= 0 ? term[base + cid] : 0;
    s_rlidx[a] = log_len[base + cid];
    s_rlterm[a] = own_lterm[base + cid];
    s_votes[a] = 0;
  }
  __syncthreads();
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j < N) {
    const long long row = base + j;
    const bool* req = del_cj + static_cast<long long>(b) * A * N + j;
    unsigned delivered = 0u;
    int32_t t_in = 0;
    for (int a = 0; a < A; ++a) {
      if (req[static_cast<long long>(a) * N]) {
        delivered |= 1u << a;
        t_in = max(t_in, s_rterm[a]);
      }
    }
    int32_t tm = term[row], rl = role[row], vf = voted_for[row];
    int32_t tmr = timer[row], to = timeout[row];
    bool rs = reset[row];
    // P2a: catch up to the highest delivered request term.
    if (t_in > tm) {
      tm = t_in;
      rl = ROLE_F;
      vf = NONE;
      to = ctt::draw_timeout(seed[b], tm, j, t_min, t_span);
    }
    // P2b: the grant, against the post-catch-up term and vote.
    const int32_t ol = own_lterm[row], ll = log_len[row];
    bool vf_elig = false;
    int32_t first = N;
    for (int a = 0; a < A; ++a) {
      const bool elig =
          ((delivered >> a) & 1u) && s_rterm[a] == tm &&
          (s_rlterm[a] > ol || (s_rlterm[a] == ol && s_rlidx[a] >= ll));
      if (elig) {
        vf_elig |= s_id[a] == vf;
        first = min(first, s_cid[a]);
      }
    }
    const int32_t grant =
        vf_elig ? vf : (vf == NONE && first < N ? first : NONE);
    if (grant >= 0) {
      vf = grant;
      tmr = 0;
      rs = true;
    }
    // P2c: a delivered grant is one vote for its candidate.
    const bool* resp = del_jc + row * A;
    if (BYZ == ctt::BYZ_NONE || j < n_honest) {
      for (int a = 0; a < A; ++a) {
        if (grant == s_id[a] && resp[a]) atomicAdd(&s_votes[a], 1);
      }
    } else if (BYZ == ctt::BYZ_EQUIV) {
      for (int a = 0; a < A; ++a) {
        if (s_id[a] >= 0 && ((delivered >> a) & 1u) && resp[a])
          atomicAdd(&s_votes[a], 1);
      }
    }
    term_out[row] = tm;
    role_out[row] = rl;
    vf_out[row] = vf;
    timer_out[row] = tmr;
    timeout_out[row] = to;
    reset_out[row] = rs;
    lead_out[row] = rl == ROLE_L &&
                    !(CRASH && (flags[row] & ctt::CRASH_DOWN));
  }
  __syncthreads();
  if (threadIdx.x < A && s_votes[threadIdx.x] != 0)
    atomicAdd(&votes[b * A + threadIdx.x], s_votes[threadIdx.x]);
}

// A thread per (sweep, candidate slot). Candidate ids of a sweep are
// distinct (kernel KC), so no two threads write one node.
__global__ void elect_winners_kernel(const int32_t* __restrict__ cand_ids,
                                     const int* __restrict__ votes,
                                     int32_t* __restrict__ role_out,
                                     int32_t* __restrict__ timer_out,
                                     bool* __restrict__ reset_out,
                                     bool* __restrict__ lead_out,
                                     bool* __restrict__ win, int B, int N,
                                     int A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * A) return;
  const int32_t id = cand_ids[i];
  bool won = false;
  if (id >= 0) {
    const int majority = N / 2 + 1;
    const long long row = static_cast<long long>(i / A) * N + min(id, N - 1);
    if (role_out[row] == ROLE_C && 1 + votes[i] >= majority) {
      role_out[row] = ROLE_L;
      timer_out[row] = 0;
      reset_out[row] = true;
      lead_out[row] = true;
      won = true;
    }
  }
  win[i] = won;
}

}  // namespace

extern "C" int ctt_elect(const uint32_t* seed, int32_t t_min, uint32_t t_span,
                         const int32_t* cand_ids, const bool* del_cj,
                         const bool* del_jc, const int32_t* term,
                         const int32_t* role, const int32_t* voted_for,
                         const int32_t* timer, const int32_t* timeout,
                         const bool* reset, const int32_t* log_len,
                         const int32_t* own_lterm, int32_t* term_out,
                         int32_t* role_out, int32_t* vf_out,
                         int32_t* timer_out, int32_t* timeout_out,
                         bool* reset_out, bool* lead_out, bool* win,
                         int* votes, const unsigned char* flags, int B, int N,
                         int A, int byz, int nb, cudaStream_t st) {
  if (A < 1 || A > MAXA || t_span == 0u || nb < 0 || nb > N ||
      byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  int err = static_cast<int>(
      cudaMemsetAsync(votes, 0, sizeof(int) * B * A, st));
  if (err != 0) return err;
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  const bool crash = flags != nullptr;
  const auto nodes =
      byz == ctt::BYZ_SILENT
          ? (crash ? elect_nodes_kernel<true, ctt::BYZ_SILENT>
                   : elect_nodes_kernel<false, ctt::BYZ_SILENT>)
      : byz == ctt::BYZ_EQUIV
          ? (crash ? elect_nodes_kernel<true, ctt::BYZ_EQUIV>
                   : elect_nodes_kernel<false, ctt::BYZ_EQUIV>)
          : (crash ? elect_nodes_kernel<true, ctt::BYZ_NONE>
                   : elect_nodes_kernel<false, ctt::BYZ_NONE>);
  nodes<<<grid, THREADS, 0, st>>>(
      seed, t_min, t_span, cand_ids, del_cj, del_jc, term, role, voted_for,
      timer, timeout, reset, log_len, own_lterm, term_out, role_out, vf_out,
      timer_out, timeout_out, reset_out, lead_out, votes, flags, N, A,
      N - nb);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  elect_winners_kernel<<<(B * A + 127) / 128, 128, 0, st>>>(
      cand_ids, votes, role_out, timer_out, reset_out, lead_out, win, B, N,
      A);
  return static_cast<int>(cudaGetLastError());
}
