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
// by its latency (two dependent reads from device memory at least: a
// node's ack target, then the mask byte it selects), so it is one launch,
// no memset, and no read after the second.
// Design: one block a sweep, since every quantity of P3d-P4 lies within
// one sweep. The ack-term maxima, the processing flags and the processing
// list live in shared memory (the block zeroes them itself).
// Where N <= 1024 (ONE) a thread holds one node's fields in registers,
// read in two waves: its own fields, then its ack's mask byte beside the
// (leader, node) match and next entries, which only it writes; once the
// block has found its first node that still leads (the candidate), also
// its entry of the candidate's match row. Between barriers:
//  A. each node takes its delivered ack's term into its leader's maximum
//     (a shared atomicMax);
//  B. each node that still leads is bumped by a higher acked term (role
//     follower, no vote, timeout redrawn inline) or is flagged and listed
//     as processing; every node then runs P4 on its settled role;
//  D. when the candidate processes, each node's entry of its row after C
//     is its entry before, raised to the node's acked length where the
//     node's successful ack went to it (C's max); the nodes count these
//     entries (one above E as E) into a 256-bin histogram in shared memory
//     (warp-aggregated shared atomics), one warp takes its suffix sums,
//     and the largest bin <= E whose sum reaches the majority is the
//     median JAX's binary search finds; then the commit advance;
//  C. each node applies its ack to its processing leader's match/next
//     entry.
// Every other processing leader (and, without ONE, every one) takes a warp
// after C: the same binary search over its finished row in memory, each
// count a warp-wide sum of byte-wise compares of the row's words
// (__vcmpgeu4), then the commit advance.
// Where N > 1024 each thread strides over several nodes and reads their
// fields again in each phase; where 4 (2N + 1) bytes exceed a block's
// shared memory (N > 29 055) the GLOBAL instance keeps the arrays in a
// [B, 2N + 1] scratch; each block zeroes and uses only its own sweep's
// part, and __syncthreads() makes its writes visible to itself.
// Why the result does not depend on the order of threads or leaders: the
// ack-term maximum is an associative max; each match_idx/next_idx entry
// has one writer (column j is node j's), and D's raised entry is the value
// C writes; each leader's median reads only its own row, and the list's
// order only says which warp takes it.
// Its CRASH instance (SPEC §6c, picked when the round's flag word of kernel
// KAH is given) changes P4 only: a node down at the round's end keeps its
// timer (the freeze, raft.py:527-536). KL cut every ack to or from a down
// node and KN listed no down leader, so nothing else reaches it.
// Its BYZ instance (SPEC §3c, picked with silent byzantine nodes: the ids
// N - nb and up) leaves their acks out of A and C: they never travel
// (raft.py:483-484); their timers still count. KN marked no silent
// byzantine leader a sender, so none is processed.
#include <cuda_runtime.h>

#include "byz.cuh"
#include "crash.cuh"
#include "rng.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_E = 255;  // mid <= E stays a u8 value
constexpr int BINS = 256;   // u8 match entries
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int32_t ROLE_F = 0, ROLE_L = 2, NONE = -1;

// A node's own fields (the first wave) and its ack's (the second).
struct Node {
  int32_t ack_to, term, role, timer, ack_match;
  bool was_leader, reset, ack_ok, acked;
  unsigned char flags;
  uint8_t match, next;
};

// The per-node inputs a Node is read from (term, role, match_idx, next_idx
// and timer are also written, through the kernel's arguments).
struct Inputs {
  const bool* __restrict__ deliver;
  const bool* __restrict__ was_leader;
  const int32_t* __restrict__ ack_to;
  const bool* __restrict__ ack_ok;
  const int32_t* __restrict__ ack_match;
  const int32_t* term;
  const int32_t* role;
  const uint8_t* match_idx;
  const uint8_t* next_idx;
  const int32_t* timer;
  const bool* __restrict__ reset;
  const unsigned char* __restrict__ flags;
};

template <bool CRASH>
__device__ __forceinline__ void load_own(Node& nd, const Inputs& in,
                                         long long row) {
  nd.ack_to = in.ack_to[row];
  nd.term = in.term[row];
  nd.role = in.role[row];
  nd.timer = in.timer[row];
  nd.ack_match = in.ack_match[row];
  nd.was_leader = in.was_leader[row];
  nd.reset = in.reset[row];
  nd.ack_ok = in.ack_ok[row];
  nd.flags = CRASH ? in.flags[row] : 0;
}

template <bool WITHHOLD>
__device__ __forceinline__ void load_ack(Node& nd, const Inputs& in,
                                         long long nodes, int j, int N,
                                         int n_honest) {
  const int32_t l = nd.ack_to;
  nd.acked = false;
  if (!(WITHHOLD && j >= n_honest) && l >= 0 && l < N) {
    // The entries are read beside the mask byte, not after it.
    const long long e = (nodes + l) * N + j;
    nd.acked = in.deliver[(nodes + j) * N + l];
    nd.match = in.match_idx[e];
    nd.next = in.next_idx[e];
  }
}

template <bool CRASH, bool WITHHOLD>
__device__ __forceinline__ Node read_node(const Inputs& in, long long nodes,
                                          int j, int N, int n_honest) {
  Node nd;
  load_own<CRASH>(nd, in, nodes + j);
  load_ack<WITHHOLD>(nd, in, nodes, j, N, n_honest);
  return nd;
}

// The entries of the u8 row `m` ([N]) that reach `mid`, summed over the
// warp: 4-byte words where the row allows it, bytes otherwise.
__device__ __forceinline__ int count_ge(const uint8_t* __restrict__ m, int N,
                                        unsigned mid, int lane) {
  int c = 0;
  if ((N & 3) == 0) {
    const unsigned* w = reinterpret_cast<const unsigned*>(m);
    const unsigned mids = mid * 0x01010101u;
    for (int k = lane; k < (N >> 2); k += 32)
      c += __popc(__vcmpgeu4(w[k], mids)) >> 3;
  } else {
    for (int k = lane; k < N; k += 32) c += m[k] >= mid;
  }
  return __reduce_add_sync(FULL, c);
}

template <bool CRASH, bool WITHHOLD, bool GLOBAL, bool ONE>
__global__ void __launch_bounds__(MAX_THREADS)
dense_acks_commit_kernel(const uint32_t* __restrict__ seed, int32_t t_min,
                         uint32_t t_span, Inputs in,
                         const int32_t* __restrict__ log_term, int32_t* term,
                         int32_t* role, int32_t* __restrict__ voted_for,
                         int32_t* __restrict__ timeout, int32_t* commit,
                         uint8_t* match_idx, uint8_t* next_idx,
                         int32_t* timer, int* __restrict__ scratch, int N,
                         int L, int E, int n_honest) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const long long nodes = static_cast<long long>(b) * N;
  // [N] ack-term maxima (later processing flags), [N] processing list, its
  // count; with ONE each warp's first node that still leads and the
  // candidate's row's [BINS] histogram.
  int* tin = GLOBAL ? scratch + b * (2LL * N + 1) : smem;
  int* list = tin + N;
  int* n_proc = list + N;
  int* warp_first = n_proc + 1;
  unsigned* hist = reinterpret_cast<unsigned*>(warp_first + MAX_THREADS / 32);
  const int majority = N / 2 + 1;
  const int lane = t & 31;
  const uint32_t sd = seed[b];

  Node own;
  if (ONE) {
    if (t < N) {
      load_own<CRASH>(own, in, nodes + t);
      load_ack<WITHHOLD>(own, in, nodes, t, N, n_honest);
    }
    const unsigned still = __ballot_sync(
        FULL, t < N && own.was_leader && own.role == ROLE_L);
    if ((t & 31) == 0)
      warp_first[t >> 5] = still != 0u ? t + __ffs(still) - 1 : N;
  }
  for (int i = t; i < N; i += T) tin[i] = 0;  // the maximum starts at 0
  if (ONE)
    for (int i = t; i < BINS; i += T) hist[i] = 0u;
  if (t == 0) *n_proc = 0;
  __syncthreads();
  int c = N, c_term = 0, c_commit = 0;
  unsigned c_entry = 0u;
  if (ONE) {
    c = __reduce_min_sync(FULL, lane < (T >> 5) ? warp_first[lane] : N);
    if (c < N) {
      const long long crow = nodes + c;
      if (t < N) c_entry = match_idx[crow * N + t];
      if (t == 0) {  // D's commit is thread 0's
        c_term = term[crow];
        c_commit = commit[crow];
      }
    }
  }

  // A. Delivered ack terms into the leaders' maxima.
  for (int j = t; j < N; j += T) {
    const Node nd =
        ONE ? own : read_node<CRASH, WITHHOLD>(in, nodes, j, N, n_honest);
    if (nd.acked && nd.term > 0) atomicMax(&tin[nd.ack_to], nd.term);
  }
  __syncthreads();

  // B. Bump or list each leader; P4 on the settled roles.
  for (int l = t; l < N; l += T) {
    const Node nd =
        ONE ? own : read_node<CRASH, WITHHOLD>(in, nodes, l, N, n_honest);
    const long long row = nodes + l;
    int32_t r = nd.role;
    const int32_t t3 = tin[l];
    const bool still = nd.was_leader && r == ROLE_L;
    const bool bumped = still && t3 > nd.term;
    if (bumped) {
      term[row] = t3;
      role[row] = r = ROLE_F;
      voted_for[row] = NONE;
      timeout[row] = ctt::draw_timeout(sd, t3, l, t_min, t_span);
    }
    const bool p = still && !bumped;
    tin[l] = p;  // only this thread reads tin[l] in B
    if (p) list[atomicAdd(n_proc, 1)] = l;
    if (CRASH && (nd.flags & ctt::CRASH_DOWN)) continue;
    if (r == ROLE_L)
      timer[row] = 0;
    else if (!nd.reset)  // wraps as the plain version's i32 add
      timer[row] =
          static_cast<int32_t>(static_cast<uint32_t>(nd.timer) + 1u);
  }
  __syncthreads();

  // D for the candidate, when it processes: its row as C leaves it, from
  // the entries read before C, into a histogram (an entry above E counts
  // as E), and the median off its suffix sums.
  const bool fast = ONE && c < N && tin[c];  // the same in every thread
  if (fast) {
    unsigned v = c_entry;
    if (t < N && own.acked && own.ack_to == c && own.ack_ok)
      v = max(v, static_cast<unsigned>(static_cast<uint8_t>(own.ack_match)));
    v = min(v, static_cast<unsigned>(E));
    const unsigned peers = __match_any_sync(FULL, t < N ? v : BINS);
    if (t < N && lane == __ffs(peers) - 1) atomicAdd(&hist[v], __popc(peers));
    __syncthreads();
    if (t < 32) {  // lane k holds bins 8k .. 8k + 7
      unsigned suf[8];
      unsigned run = 0u;
#pragma unroll
      for (int i = 7; i >= 0; --i) suf[i] = run += hist[8 * lane + i];
      unsigned above = run;  // then: the entries in the bins of lanes > k
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned x = __shfl_down_sync(FULL, above, d);
        if (lane + d < 32) above += x;
      }
      above -= run;
      // The suffix sums fall with the bin, and bin 0's is N: the largest
      // bin <= E that reaches the majority is what the binary search
      // returns.
      int best = -1;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * lane + i <= E && suf[i] + above >= unsigned(majority))
          best = 8 * lane + i;
      const int med = __reduce_max_sync(FULL, best);
      const int kmed = min(max(med - 1, 0), L - 1);
      if (t == 0 && med > 0 && med > c_commit &&
          log_term[(nodes + c) * L + kmed] == c_term)
        commit[nodes + c] = med;
    }
  }

  // C. Acks into the processing leaders' rows (column j is node j's).
  for (int j = t; j < N; j += T) {
    const Node nd =
        ONE ? own : read_node<CRASH, WITHHOLD>(in, nodes, j, N, n_honest);
    if (!nd.acked || !tin[nd.ack_to]) continue;
    const long long e = (nodes + nd.ack_to) * N + j;
    if (nd.ack_ok) {
      const uint8_t acked = static_cast<uint8_t>(nd.ack_match);
      const uint8_t m = nd.match > acked ? nd.match : acked;
      match_idx[e] = m;
      next_idx[e] = static_cast<uint8_t>(m + 1);
    } else {
      const uint8_t dec = static_cast<uint8_t>(nd.next - 1);
      next_idx[e] = dec > 1 ? dec : 1;
    }
  }
  const int np = *n_proc;
  if (np <= (fast ? 1 : 0)) return;  // the same in every thread
  __syncthreads();

  // D for every other processing leader: a warp each, over its finished
  // row, and the commit.
  for (int q = t >> 5; q < np; q += T >> 5) {
    const int l = list[q];
    if (fast && l == c) continue;
    const uint8_t* m = match_idx + (nodes + l) * N;
    int lo = 0, hi = E + 1;
    for (int it = 32 - __clz(E + 1); it > 0; --it) {
      const int mid = (lo + hi) >> 1;
      if (count_ge(m, N, static_cast<unsigned>(mid), lane) >= majority)
        lo = mid;
      else
        hi = mid;
    }
    if (lane == 0) {
      const long long row = nodes + l;
      const int kmed = min(max(lo - 1, 0), L - 1);
      if (lo > 0 && lo > commit[row] && log_term[row * L + kmed] == term[row])
        commit[row] = lo;
    }
  }
}

template <bool CRASH, bool WITHHOLD, bool GLOBAL, bool ONE>
int launch(int B, int threads, size_t smem, cudaStream_t st,
           const uint32_t* seed, int32_t t_min, uint32_t t_span,
           const Inputs& in, const int32_t* log_term, int32_t* term,
           int32_t* role, int32_t* voted_for, int32_t* timeout,
           int32_t* commit, uint8_t* match_idx, uint8_t* next_idx,
           int32_t* timer, int* scratch, int N, int L, int E, int n_honest) {
  const auto kernel = dense_acks_commit_kernel<CRASH, WITHHOLD, GLOBAL, ONE>;
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err != 0) return err;
  }
  kernel<<<B, threads, smem, st>>>(seed, t_min, t_span, in, log_term, term,
                                   role, voted_for, timeout, commit,
                                   match_idx, next_idx, timer, scratch, N, L,
                                   E, n_honest);
  return static_cast<int>(cudaGetLastError());
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
  if (t_span == 0u || E < 0 || E > MAX_E || E > L || nb < 0 || nb > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const Inputs in{deliver, was_leader, ack_to,   ack_ok, ack_match,
                  term,    role,       match_idx, next_idx, timer,
                  reset,   flags};
  // A warp's worth of threads at least (the warp-wide counts).
  const int threads = N >= MAX_THREADS ? MAX_THREADS : (N + 31) & ~31;
  const bool one = N <= MAX_THREADS;
  const size_t arrays =
      sizeof(int) * (2 * static_cast<size_t>(N) + 1 +
                     (one ? MAX_THREADS / 32 + BINS : 0));
  const bool global = arrays > static_cast<size_t>(SMEM_MAX);
  const size_t smem = global ? 0 : arrays;
  const bool crash = flags != nullptr;
  const bool withhold = byz == ctt::BYZ_SILENT;
#define KO_LAUNCH(C, W, G, O)                                               \
  launch<C, W, G, O>(B, threads, smem, st, seed, t_min, t_span, in,         \
                     log_term, term, role, voted_for, timeout, commit,      \
                     match_idx, next_idx, timer, scratch, N, L, E, N - nb)
#define KO_PICK(G, O)                                                       \
  (crash ? (withhold ? KO_LAUNCH(true, true, G, O)                          \
                     : KO_LAUNCH(true, false, G, O))                        \
         : (withhold ? KO_LAUNCH(false, true, G, O)                         \
                     : KO_LAUNCH(false, false, G, O)))
  if (global) return KO_PICK(true, false);
  return one ? KO_PICK(false, true) : KO_PICK(false, false);
#undef KO_PICK
#undef KO_LAUNCH
}
