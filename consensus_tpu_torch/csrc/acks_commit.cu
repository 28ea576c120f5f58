// Kernel KH: SPEC §3 P3d, the tracked leaders' processing of their
// followers' acks, P3e, the majority commit, and P4, the timers, updating
// the round's state in place.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round P3d
// (lines 441-468: the ack-term maximum per slot, the leader's term bump,
// the u8 match/next update) and P3e (lines 470-489: the majority-th largest
// match of each tracked row by a fixed-depth binary search over [0, E],
// which makes log2(E) + 1 count passes over the [A, N] rows, then the
// commit advance when that entry is of the leader's term) and P4 (line
// 492: leaders hold their timer at 0, other nodes count it up unless the
// round reset it).
//
// Bound: bytes. Per node it reads its ack flag; per acking node its slot
// and one byte of the ack mask, and per delivered ack the node's term;
// per (processing slot, node) the match byte; per ack to a processing
// slot the apply flag, and either the new log length and a write of match
// and next, or a read and a write of next. At the flagship shape (B = 8,
// A = 8, N = 100 000) with every slot processing and every node acking,
// that is at most 12 MB + 6.4 MB + acks, about 6 us at 3.35 TB/s. The
// binary search's passes become one histogram. P4 reads every role, the
// reset flag of each node that does not lead, and reads and writes the
// timers that count (not reset) and writes the leaders': 5 to 13 bytes a
// node.
// Design: five launches on the stream.
//  1. A thread per node: the slot it acks, if the ack was delivered, takes
//     the node's term into a block-partial maximum in shared memory, then
//     one global atomicMax per (block, slot).
//  2. A thread per (sweep, slot): still leading, bump on a higher acked
//     term (role follower, no vote, timeout redrawn under the new term), or
//     mark the slot as processing. Tracked ids are distinct (kernel KC), so
//     no two threads write one node.
//  3. Per processing slot, blocks over its [N] row: each thread applies the
//     acks of its nodes to match/next in place, with u8 wrap as JAX, and
//     counts the new match values in a 256-bin shared histogram (equal
//     values within a warp are added once, via __match_any_sync); a block
//     adds its nonzero bins to the slot's global histogram.
//  4. A thread per (sweep, slot): the largest m <= E whose suffix count
//     (entries >= m, values above E included) reaches the majority; that is
//     what the binary search over [0, E + 1) returns. Then the commit
//     advance, against the post-P3c log and the post-bump term.
//  5. A thread per node: P4, after launch 2 has settled every role. Its
//     CRASH instance (SPEC §6c, picked when the round's flag word of kernel
//     KAH is given) leaves the timer of a node down at the round's end as
//     it is (the freeze, raft_sparse.py:494-501); launches 1-4 need no
//     change, since KB cut every ack to or from a down node and the tracked
//     leaders are up.
// Its BYZ instance (SPEC §3c, picked with silent byzantine nodes: the ids
// N - nb and up) leaves their acks out of launches 1 and 3: they never
// travel (raft_sparse.py:446-447). A silent byzantine leader's slot is not
// processed at all: kernel KI marked it unsent.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXA = 16;
constexpr int BINS = 256;
// Row entries one block of launch 3 covers.
constexpr int CHUNK = THREADS * 16;
constexpr int32_t ROLE_F = 0, ROLE_L = 2, NONE = -1;

// Launch 1. Grid (ceil(N / THREADS), B).
template <bool WITHHOLD>
__global__ void __launch_bounds__(THREADS)
ack_term_kernel(const bool* __restrict__ del_jl,
                const bool* __restrict__ has_l,
                const int32_t* __restrict__ kstar,
                const int32_t* __restrict__ term, int* __restrict__ t_in3,
                int N, int A, int n_honest) {
  __shared__ int s_max[MAXA];
  const int b = blockIdx.y;
  if (threadIdx.x < A) s_max[threadIdx.x] = 0;
  __syncthreads();
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j < N && !(WITHHOLD && j >= n_honest)) {
    const long long row = static_cast<long long>(b) * N + j;
    if (has_l[row]) {
      const int k = kstar[row];
      if (k >= 0 && k < A && del_jl[row * A + k] && term[row] > 0)
        atomicMax(&s_max[k], term[row]);
    }
  }
  __syncthreads();
  if (threadIdx.x < A && s_max[threadIdx.x] > 0)
    atomicMax(&t_in3[b * A + threadIdx.x], s_max[threadIdx.x]);
}

// Launch 2. A thread per (sweep, slot).
__global__ void slot_bump_kernel(const uint32_t* __restrict__ seed,
                                 int32_t t_min, uint32_t t_span,
                                 const int32_t* __restrict__ lead_id,
                                 const bool* __restrict__ was_lead_k,
                                 const int* __restrict__ t_in3,
                                 int32_t* __restrict__ term,
                                 int32_t* __restrict__ role,
                                 int32_t* __restrict__ voted_for,
                                 int32_t* __restrict__ timeout,
                                 int* __restrict__ proc, int B, int N,
                                 int A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * A) return;
  proc[i] = 0;
  if (!was_lead_k[i]) return;
  const int b = i / A;
  const int lid = min(max(lead_id[i], 0), N - 1);
  const long long row = static_cast<long long>(b) * N + lid;
  if (role[row] != ROLE_L) return;
  const int32_t t3 = t_in3[i];
  if (t3 > term[row]) {
    term[row] = t3;
    role[row] = ROLE_F;
    voted_for[row] = NONE;
    timeout[row] = ctt::draw_timeout(seed[b], t3, lid, t_min, t_span);
    return;
  }
  proc[i] = 1;
}

// Launch 3. Grid (ceil(N / CHUNK), B * A).
template <bool WITHHOLD>
__global__ void __launch_bounds__(THREADS)
match_next_kernel(const bool* __restrict__ del_jl,
                  const bool* __restrict__ has_l,
                  const int32_t* __restrict__ kstar,
                  const bool* __restrict__ apply_,
                  const int32_t* __restrict__ log_len,
                  const int* __restrict__ proc,
                  uint8_t* __restrict__ lead_match,
                  uint8_t* __restrict__ lead_next,
                  unsigned* __restrict__ hist, int N, int A,
                  int n_honest) {
  const int slot = blockIdx.y;  // b * A + a
  if (!proc[slot]) return;      // uniform across the block
  __shared__ unsigned s_hist[BINS];
  for (int v = threadIdx.x; v < BINS; v += THREADS) s_hist[v] = 0u;
  __syncthreads();
  const int b = slot / A, a = slot - b * A;
  const int lo = blockIdx.x * CHUNK;
  const int hi = min(N, lo + CHUNK);
  uint8_t* m_row = lead_match + static_cast<long long>(slot) * N;
  uint8_t* n_row = lead_next + static_cast<long long>(slot) * N;
  const long long nodes = static_cast<long long>(b) * N;
  // Every lane runs every iteration, so the warp-wide match is legal.
  for (int base = lo; base < hi; base += THREADS) {
    const int j = base + threadIdx.x;
    int key = BINS;  // no value: lanes past the row's end
    if (j < hi) {
      const long long row = nodes + j;
      uint8_t m = m_row[j];
      if (!(WITHHOLD && j >= n_honest) && has_l[row] && kstar[row] == a &&
          del_jl[row * A + a]) {
        uint8_t n;
        if (apply_[row]) {
          const uint8_t acked = static_cast<uint8_t>(log_len[row]);
          m = m > acked ? m : acked;
          n = static_cast<uint8_t>(m + 1);
          m_row[j] = m;
        } else {
          const uint8_t dec = static_cast<uint8_t>(n_row[j] - 1);
          n = dec > 1 ? dec : 1;
        }
        n_row[j] = n;
      }
      key = m;
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
    if (key < BINS && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&s_hist[key], static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  unsigned* h = hist + static_cast<long long>(slot) * BINS;
  for (int v = threadIdx.x; v < BINS; v += THREADS)
    if (s_hist[v] != 0u) atomicAdd(&h[v], s_hist[v]);
}

// Launch 4. A thread per (sweep, slot).
__global__ void commit_kernel(const int32_t* __restrict__ lead_id,
                              const int* __restrict__ proc,
                              const unsigned* __restrict__ hist,
                              const int32_t* __restrict__ log_term,
                              const int32_t* __restrict__ term,
                              int32_t* __restrict__ commit, int B, int N,
                              int A, int L, int E) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * A || !proc[i]) return;
  const unsigned majority = static_cast<unsigned>(N / 2 + 1);
  const unsigned* h = hist + static_cast<long long>(i) * BINS;
  unsigned above = 0u;
  for (int v = BINS - 1; v > E; --v) above += h[v];
  int med = 0;
  for (int m = E; m >= 0; --m) {
    above += h[m];
    if (above >= majority) {
      med = m;
      break;
    }
  }
  const int lid = min(max(lead_id[i], 0), N - 1);
  const long long row = static_cast<long long>(i / A) * N + lid;
  const int kmed = min(max(med - 1, 0), L - 1);
  if (med > 0 && med > commit[row] && log_term[row * L + kmed] == term[row])
    commit[row] = med;
}

// Launch 5. Grid (ceil(B * N / THREADS)).
template <bool CRASH>
__global__ void __launch_bounds__(THREADS)
timers_kernel(const int32_t* __restrict__ role,
              const bool* __restrict__ reset, int32_t* __restrict__ timer,
              const unsigned char* __restrict__ flags, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  if (CRASH && (flags[row] & ctt::CRASH_DOWN)) return;
  if (role[row] == ROLE_L)
    timer[row] = 0;
  else if (!reset[row])  // wraps as the plain version's i32 add
    timer[row] = static_cast<int32_t>(static_cast<uint32_t>(timer[row]) + 1u);
}

}  // namespace

extern "C" int ctt_acks_commit(
    const uint32_t* seed, int32_t t_min, uint32_t t_span,
    const int32_t* lead_id, const bool* was_lead_k, const bool* del_jl,
    const bool* has_l, const int32_t* kstar, const bool* apply_,
    const int32_t* log_len, const int32_t* log_term, int32_t* term,
    int32_t* role, int32_t* voted_for, int32_t* timeout, int32_t* commit,
    uint8_t* lead_match, uint8_t* lead_next, int32_t* timer,
    const bool* reset, int* t_in3, int* proc, unsigned* hist,
    const unsigned char* flags, int B, int N, int A, int L, int E, int byz,
    int nb, cudaStream_t st) {
  if (A < 1 || A > MAXA || t_span == 0u || E < 0 || E >= BINS || nb < 0 ||
      nb > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  int err = static_cast<int>(
      cudaMemsetAsync(t_in3, 0, sizeof(int) * B * A, st));
  if (err == 0)
    err = static_cast<int>(cudaMemsetAsync(
        hist, 0, sizeof(unsigned) * BINS * B * A, st));
  if (err != 0) return err;
  const bool withhold = byz == ctt::BYZ_SILENT;
  const auto ack_term = withhold ? ack_term_kernel<true>
                                 : ack_term_kernel<false>;
  ack_term<<<dim3((N + THREADS - 1) / THREADS, B), THREADS, 0, st>>>(
      del_jl, has_l, kstar, term, t_in3, N, A, N - nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const int small = (B * A + 127) / 128;
  slot_bump_kernel<<<small, 128, 0, st>>>(seed, t_min, t_span, lead_id,
                                          was_lead_k, t_in3, term, role,
                                          voted_for, timeout, proc, B, N, A);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const auto match_next = withhold ? match_next_kernel<true>
                                   : match_next_kernel<false>;
  match_next<<<dim3((N + CHUNK - 1) / CHUNK, B * A), THREADS, 0, st>>>(
      del_jl, has_l, kstar, apply_, log_len, proc, lead_match, lead_next,
      hist, N, A, N - nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  commit_kernel<<<small, 128, 0, st>>>(lead_id, proc, hist, log_term, term,
                                       commit, B, N, A, L, E);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const long long rows = static_cast<long long>(B) * N;
  const auto timers = flags != nullptr ? timers_kernel<true>
                                       : timers_kernel<false>;
  timers<<<static_cast<unsigned>((rows + THREADS - 1) / THREADS), THREADS, 0,
           st>>>(role, reset, timer, flags, rows);
  return static_cast<int>(cudaGetLastError());
}
