// Kernel KU: SPEC §6b P4 the prepare quorum and P5 the commit quorum of the
// broadcast PBFT round at every (node, slot) of each lane, with the lane's
// population n_real and tolerance f read per lane.
//
// Replaces: consensus_tpu/engines/pbft_bcast.py _SortedRuns, _top_runs,
// _table_count and _aggregate_tallies (K15, lines 147-357) as
// pbft_bcast_round calls them on its flat path (lines 615-628), and the
// same phases of consensus_tpu/engines/pbft_sweep.py
// pbft_bcast_round_padded (K17) lines 452-458. Per (lane, slot, side) the
// counting set of a phase is the senders of that side (bit 0 and bit 1 of
// the node byte KT wrote) that are relevant: they have seen the slot (P4)
// or prepared it after P4 (P5). Node j's count is the number of counting
// senders of its side whose value in the slot is j's, plus one where j is
// real, relevant and not a sender; P4 prepares the slot where j has seen
// it and the count reaches Q = 2f + 1, P5 commits it, with j's value
// decided, where j prepared it, the count reaches Q and j had not
// committed it.
//
// Exactness without the JAX package's sort: a count that can reach Q is at
// least Tmin = 2f - eb, where eb is the number of equivocators (0 without
// them): the self term adds at most one and a receiver's extra (below) at
// most eb. Config holds eb <= f, so Tmin >= f >= 1 at f >= 1. The counting
// set has at most n_real = 3f + 1 senders. The table width m is the JAX
// package's _table_width, max(1, min(n_real, n_real // Tmin)) (lines
// 130-144), or on a ladder the largest of its rungs' (pbft_sweep.py:629-631):
// 1 at f >= 2 and 2 at f = 1 without equivocators, 3 at eb = f >= 2, 4 at
// eb = f = 1, never more than 4. Either m = n_real // Tmin, and then
// (m + 1) Tmin > n_real, or m = n_real >= n_real / Tmin; so n_real /
// (m + 1) < Tmin in every case, and a ladder lane's larger m_cap only widens
// the summary. Every value that can pass therefore has a count above
// n / (m + 1) for its counting set of n <= n_real senders, and a
// Misra-Gries summary of m counters, built in pieces and merged in any
// order, keeps it. Each phase recounts its at most m candidates exactly,
// and every other value counts 0 here, where the JAX package's table may
// hold its true count below the threshold: the quorum decisions, and so
// every output, are the same. At m = n_real (f = eb = 1: four counters for
// four nodes) the summary keeps every value of the slot outright.
//
// Bound: bytes. Each (node, slot) reads pp_seen, pp_val, prepared,
// committed and dval and writes prepared, committed and dval (17 bytes);
// each node's byte is read. At pbft-100k-bcast (B = 8, N = 100 000, S =
// 16) that is about 218 MB a round, 65 us at 3.35 TB/s. The five passes
// read pp_val five times and the node bytes once a slot, so this design
// moves about three times those bytes.
// Design: five launches on the stream, after a memset of the counters,
// all on one grid: a block per 1024 nodes of a lane and a group of up to
// 256 slots ((lane, node block) flattened into the grid's x, so the lane
// count has no grid limit of its own), each thread owning one slot and walking the block's nodes at
// a stride, eight nodes' loads issued before their use, so that a warp
// reads consecutive (node, slot) entries and keeps several loads in
// flight. The summaries' width m is a template parameter (1 or 2
// counters): at one counter the merges are the majority vote's.
//  1. P4 candidates: each thread folds its relevant senders into a
//     Misra-Gries summary a side; the block merges its threads' summaries
//     a (slot, side) and writes them; the lane's last block to finish
//     (a counter a lane and slot group) merges all blocks' summaries, a
//     warp a (slot, side) with a shuffle tree, into the candidates.
//  2. P4 recount: exact counts of the candidates, block sums in shared
//     memory, one global atomic a block and counter.
//  3. P4 lookup (prepared written), then P5 candidates as in 1, from the
//     post-P4 prepared flags of the same entries.
//  4. P5 recount.
//  5. P5 lookup: committed and decided values written.
// Its CRASH instance (SPEC §6c, picked by the launch's `crash` argument)
// keeps a node of bit 2 (down at the round's end, set by KT) from
// preparing in launch 3 (pbft_bcast.py:331-335). Its commits are counted
// as the round's tally reaches them, which the telemetry's commit_missed
// reads; kernel KAA leaves them out of the quorums it counts and the
// freeze (kernel KAI) drops them from the state.
// Its BYZ instances (SPEC §3c/§7c, picked with byzantine nodes: node i of a
// lane is honest when i < n_real - nb, byz.cuh) count the honest senders of
// bit 0 only (bit 0 also marks a byzantine node's broadcast), and the self
// term only where the receiver is honest (pbft_bcast.py:276-284, 328,
// 351). Under equivocation each receiver's `extra` (kernel KAK) adds to its
// P4 count in launch 3 and its P5 count in launch 5 (lines 322-353): launch
// 3 decides each node's prepared flag with its own extra, which is the JAX
// package's sorted-space P4 -> P5 chain, and launches 4 and 5 read those
// flags. Summaries of 3 and 4 counters run only in these instances.
#include <cuda_runtime.h>

#include <cstdint>

#include "byz.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int CHUNK = 1024;  // nodes a block (as engines/pbft_bcast.py)
constexpr int MAX_M = 4;     // the widest table (as engines/pbft_bcast.py)
constexpr int MAX_SG = 256;  // slots a block
constexpr int UNROLL = 8;    // nodes a thread loads before it uses them

// A Misra-Gries summary of M counters: keys k, counts c (0: unused).
template <int M>
struct Summary {
  int32_t k[M];
  int c[M];
};

template <int M>
__device__ __forceinline__ void clear(Summary<M>& a) {
#pragma unroll
  for (int q = 0; q < M; ++q) {
    a.k[q] = 0;
    a.c[q] = 0;
  }
}

// Fold one occurrence of x into a.
template <int M>
__device__ __forceinline__ void mg_insert(Summary<M>& a, int32_t x) {
#pragma unroll
  for (int q = 0; q < M; ++q)
    if (a.c[q] > 0 && a.k[q] == x) {
      ++a.c[q];
      return;
    }
#pragma unroll
  for (int q = 0; q < M; ++q)
    if (a.c[q] == 0) {
      a.k[q] = x;
      a.c[q] = 1;
      return;
    }
#pragma unroll
  for (int q = 0; q < M; ++q) --a.c[q];
}

// Merge b into a: add the counts of equal keys, then take the (M+1)-th
// largest count from every counter and keep the positive ones (mergeable
// Misra-Gries). For M = 1 that is the majority vote's pair merge.
template <int M>
__device__ __forceinline__ void mg_merge(Summary<M>& a, const Summary<M>& b) {
  if (M == 1) {
    if (b.c[0] == 0) return;
    if (a.c[0] > 0 && a.k[0] == b.k[0]) {
      a.c[0] += b.c[0];
    } else if (a.c[0] >= b.c[0]) {
      a.c[0] -= b.c[0];
    } else {
      a.k[0] = b.k[0];
      a.c[0] = b.c[0] - a.c[0];
    }
    return;
  }
  int32_t kk[2 * M];
  int cc[2 * M];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    kk[q] = a.k[q];
    cc[q] = a.c[q];
  }
#pragma unroll
  for (int q = 0; q < M; ++q) {
    int cb = b.c[q];
#pragma unroll
    for (int p = 0; p < M; ++p)
      if (cb > 0 && cc[p] > 0 && kk[p] == b.k[q]) {
        cc[p] += cb;
        cb = 0;
      }
    kk[M + q] = b.k[q];
    cc[M + q] = cb;
  }
  int th = 0;
#pragma unroll
  for (int x = 0; x < 2 * M; ++x) {
    int gt = 0, ge = 0;
#pragma unroll
    for (int y = 0; y < 2 * M; ++y) {
      gt += cc[y] > cc[x];
      ge += cc[y] >= cc[x];
    }
    if (gt <= M && M < ge) th = cc[x];
  }
  int n = 0;
  clear(a);
#pragma unroll
  for (int x = 0; x < 2 * M; ++x)
    if (cc[x] > th) {
#pragma unroll
      for (int q = 0; q < M; ++q)
        if (q == n) {
          a.k[q] = kk[x];
          a.c[q] = cc[x] - th;
        }
      ++n;
    }
}

template <int M>
__device__ __forceinline__ Summary<M> shfl_down(const Summary<M>& a,
                                                int off) {
  Summary<M> b;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    b.k[q] = __shfl_down_sync(FULL, a.k[q], off);
    b.c[q] = __shfl_down_sync(FULL, a.c[q], off);
  }
  return b;
}

// Where a block's thread works: its lane b, node block blk of nblk, slot s
// (valid when on) and the node range it walks, from i0 + sub at a stride
// of P. Grid x is b * nblk + blk.
struct Place {
  int b, blk, nblk, s, sub, P, i0, i1;
  bool on;
};

__device__ __forceinline__ Place place(int N, int S) {
  const int SG = S < MAX_SG ? S : MAX_SG;
  const int P = THREADS / SG;
  Place pl;
  pl.nblk = (N + CHUNK - 1) / CHUNK;
  pl.b = blockIdx.x / pl.nblk;
  pl.blk = blockIdx.x - pl.b * pl.nblk;
  pl.P = P;
  pl.sub = threadIdx.x / SG;
  pl.s = blockIdx.z * SG + static_cast<int>(threadIdx.x) % SG;
  pl.on = static_cast<int>(threadIdx.x) < P * SG && pl.s < S;
  pl.i0 = pl.blk * CHUNK;
  pl.i1 = min(pl.i0 + CHUNK, N);
  return pl;
}

// Scratch, in int32 words (engines/pbft_bcast.py tally_scratch_ints): the
// zeroed part first. Tables hold MAX_M entries; a run uses the first M.
struct Scratch {
  int* counts;   // [2 phases][B][S][2][MAX_M] exact counts
  int* done;     // [2 phases][B][groups] blocks finished
  int* cand_k;   // [2 phases][B][S][2][MAX_M]
  int* cand_c;   // [2 phases][B][S][2][MAX_M], 0 for no candidate
  int* summ_k;   // [B][nblk][S][2][MAX_M] a block's summaries
  int* summ_c;
};

__device__ __forceinline__ long long table_at(int b, int s, int side, int S) {
  return ((static_cast<long long>(b) * S + s) * 2 + side) * MAX_M;
}

// The block's summaries -> global; the lane's last block merges them all
// into the phase's candidates. Every thread of the block calls it.
template <int M>
__device__ void merge_and_publish(const Place& pl, int phase, int B, int S,
                                  const Summary<M> (&mine)[2], Scratch sc) {
  __shared__ Summary<M> sh[THREADS][2];
  __shared__ bool last;
  const int t = threadIdx.x;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    sh[t][side] = mine[side];
    if (!pl.on) clear(sh[t][side]);
  }
  __syncthreads();
  const int SG = S < MAX_SG ? S : MAX_SG;
  const int nblk = pl.nblk;
  for (int pair = t; pair < 2 * SG; pair += THREADS) {
    const int sl = pair >> 1, side = pair & 1;
    const int s = blockIdx.z * SG + sl;
    if (s >= S) continue;
    Summary<M> a = sh[sl][side];
    for (int p = 1; p < pl.P; ++p) mg_merge(a, sh[p * SG + sl][side]);
    const long long o =
        (static_cast<long long>(pl.b) * nblk + pl.blk) * S * 2 * MAX_M +
        (static_cast<long long>(s) * 2 + side) * MAX_M;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      sc.summ_k[o + q] = a.k[q];
      sc.summ_c[o + q] = a.c[q];
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const int groups = gridDim.z;
    const int ticket = atomicAdd(
        &sc.done[(phase * B + pl.b) * groups + blockIdx.z], 1);
    last = ticket == nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = t >> 5, lane = t & 31;
  for (int pair = warp; pair < 2 * SG; pair += WARPS) {
    const int sl = pair >> 1, side = pair & 1;
    const int s = blockIdx.z * SG + sl;
    if (s >= S) continue;  // uniform in the warp
    Summary<M> a;
    clear(a);
    for (int blk = lane; blk < nblk; blk += 32) {
      const long long o =
          (static_cast<long long>(pl.b) * nblk + blk) * S * 2 * MAX_M +
          (static_cast<long long>(s) * 2 + side) * MAX_M;
      Summary<M> b;
#pragma unroll
      for (int q = 0; q < M; ++q) {
        b.k[q] = __ldcg(sc.summ_k + o + q);
        b.c[q] = __ldcg(sc.summ_c + o + q);
      }
      mg_merge(a, b);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const Summary<M> b = shfl_down(a, off);
      if (lane + off < 32) mg_merge(a, b);
    }
    if (lane == 0) {
      const long long o =
          static_cast<long long>(phase) * B * S * 2 * MAX_M +
          table_at(pl.b, s, side, S);
#pragma unroll
      for (int q = 0; q < MAX_M; ++q) {
        sc.cand_k[o + q] = q < M ? a.k[q] : 0;
        sc.cand_c[o + q] = q < M ? a.c[q] : 0;
      }
    }
  }
}

// A thread's candidates of its slot, both sides, with their exact counts
// (or 1 without them); a count of 0 marks no candidate.
template <int M>
__device__ __forceinline__ void load_table(const Place& pl, int phase,
                                           int B, int S, const Scratch& sc,
                                           bool exact, Summary<M> (&tb)[2]) {
  clear(tb[0]);
  clear(tb[1]);
  if (!pl.on) return;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const long long o = static_cast<long long>(phase) * B * S * 2 * MAX_M +
                        table_at(pl.b, pl.s, side, S);
#pragma unroll
    for (int q = 0; q < M; ++q) {
      tb[side].k[q] = __ldcg(sc.cand_k + o + q);
      const int cand = __ldcg(sc.cand_c + o + q);
      tb[side].c[q] = cand > 0 ? (exact ? __ldcg(sc.counts + o + q) : 1) : 0;
    }
  }
}

// The table count of value x on a side: its candidate's exact count, or 0.
template <int M>
__device__ __forceinline__ int lookup(const Summary<M> (&tb)[2], int side,
                                      int32_t x) {
  int n = 0;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const int32_t k = side ? tb[1].k[q] : tb[0].k[q];
    const int c = side ? tb[1].c[q] : tb[0].c[q];
    if (c > 0 && k == x) n += c;
  }
  return n;
}

// The ids below which a lane's nodes are honest: n_real (BYZ: n_real - nb).
template <bool BYZ>
__device__ __forceinline__ int honest_top(const int32_t* __restrict__ n_real,
                                          int b, int nb) {
  return BYZ ? n_real[b] - nb : n_real[b];
}

// Launches 1 and 3. LOOKUP4: fold P4's lookup in first (launch 3), else
// the relevant flags are pp_seen (launch 1).
template <int M, bool LOOKUP4, bool CRASH, bool BYZ>
__global__ void __launch_bounds__(THREADS)
tally_candidates_kernel(const int32_t* __restrict__ n_real,
                        const int32_t* __restrict__ f,
                        const uint8_t* __restrict__ bits,
                        const bool* __restrict__ pp_seen,
                        const int32_t* __restrict__ pp_val,
                        const bool* __restrict__ prepared,
                        bool* __restrict__ prep_out, Scratch sc, int B,
                        int N, int S, int nb,
                        const int32_t* __restrict__ extra) {
  const Place pl = place(N, S);
  Summary<M> mine[2];
  clear(mine[0]);
  clear(mine[1]);
  Summary<M> tb[2];
  if (LOOKUP4) load_table(pl, 0, B, S, sc, true, tb);
  if (pl.on) {
    const int n = honest_top<BYZ>(n_real, pl.b, nb);
    const int q4 = 2 * f[pl.b] + 1;
    const long long nodes = static_cast<long long>(pl.b) * N;
    const bool ex = LOOKUP4 && BYZ && extra != nullptr;
    for (int i = pl.i0 + pl.sub; i < pl.i1; i += UNROLL * pl.P) {
      uint8_t bu[UNROLL];
      int32_t xu[UNROLL], eu[UNROLL];
      bool seen[UNROLL], prep[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int iu = i + u * pl.P;
        const bool in = iu < pl.i1;
        const long long e = (nodes + iu) * S + pl.s;
        bu[u] = in ? bits[nodes + iu] : 0;
        xu[u] = in ? pp_val[e] : 0;
        seen[u] = in && pp_seen[e];
        prep[u] = LOOKUP4 && in && prepared[e];
        eu[u] = ex && in ? extra[nodes + iu] : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int iu = i + u * pl.P;
        const uint8_t bi = bu[u];
        const int side = (bi >> 1) & 1;
        bool rel = seen[u];
        if (LOOKUP4 && iu < pl.i1) {
          const int cnt = lookup(tb, side, xu[u]) +
                          (iu < n && !(bi & 1) && rel) + eu[u];
          rel = prep[u] || (rel && cnt >= q4 && !(CRASH && (bi & 4)));
          prep_out[(nodes + iu) * S + pl.s] = rel;
        }
        if ((bi & 1) && (!BYZ || iu < n) && rel) mg_insert(mine[side], xu[u]);
      }
    }
  }
  merge_and_publish(pl, LOOKUP4 ? 1 : 0, B, S, mine, sc);
}

// Launches 2 and 4: exact counts of the phase's candidates.
template <int M, bool BYZ>
__global__ void __launch_bounds__(THREADS)
tally_recount_kernel(const int32_t* __restrict__ n_real,
                     const uint8_t* __restrict__ bits,
                     const bool* __restrict__ relevant,
                     const int32_t* __restrict__ pp_val, Scratch sc,
                     int phase, int B, int N, int S, int nb) {
  __shared__ int sums[MAX_SG][2][M];
  const Place pl = place(N, S);
  const int SG = S < MAX_SG ? S : MAX_SG;
  for (int k = threadIdx.x; k < SG * 2 * M; k += THREADS)
    (&sums[0][0][0])[k] = 0;
  Summary<M> tb[2];
  load_table(pl, phase, B, S, sc, false, tb);
  int cnt[2][M];
#pragma unroll
  for (int q = 0; q < M; ++q) cnt[0][q] = cnt[1][q] = 0;
  if (pl.on) {
    const long long nodes = static_cast<long long>(pl.b) * N;
    // BYZ: the senders from the first byzantine id up count nothing.
    const int i1 = BYZ ? min(pl.i1, honest_top<true>(n_real, pl.b, nb))
                       : pl.i1;
    for (int i = pl.i0 + pl.sub; i < i1; i += UNROLL * pl.P) {
      uint8_t bu[UNROLL];
      int32_t xu[UNROLL];
      bool rel[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int iu = i + u * pl.P;
        const bool in = iu < i1;
        const long long e = (nodes + iu) * S + pl.s;
        bu[u] = in ? bits[nodes + iu] : 0;
        xu[u] = in ? pp_val[e] : 0;
        rel[u] = in && relevant[e];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!(bu[u] & 1) || !rel[u]) continue;
#pragma unroll
        for (int q = 0; q < M; ++q) {
          if (bu[u] & 2)
            cnt[1][q] += tb[1].c[q] > 0 && tb[1].k[q] == xu[u];
          else
            cnt[0][q] += tb[0].c[q] > 0 && tb[0].k[q] == xu[u];
        }
      }
    }
  }
  __syncthreads();
  const int sl = static_cast<int>(threadIdx.x) % SG;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    if (cnt[0][q]) atomicAdd(&sums[sl][0][q], cnt[0][q]);
    if (cnt[1][q]) atomicAdd(&sums[sl][1][q], cnt[1][q]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < SG * 2 * M; k += THREADS) {
    const int s = blockIdx.z * SG + k / (2 * M);
    const int v = (&sums[0][0][0])[k];
    if (s < S && v != 0) {
      const int side = (k / M) & 1, q = k % M;
      atomicAdd(&sc.counts[static_cast<long long>(phase) * B * S * 2 *
                               MAX_M +
                           table_at(pl.b, s, side, S) + q],
                v);
    }
  }
}

// Launch 5: P5's lookup.
template <int M, bool BYZ>
__global__ void __launch_bounds__(THREADS)
tally_commit_kernel(const int32_t* __restrict__ n_real,
                    const int32_t* __restrict__ f,
                    const uint8_t* __restrict__ bits,
                    const int32_t* __restrict__ pp_val,
                    const bool* __restrict__ prep,
                    const bool* __restrict__ committed,
                    const int32_t* __restrict__ dval,
                    bool* __restrict__ com_out,
                    int32_t* __restrict__ dval_out, Scratch sc, int B,
                    int N, int S, int nb,
                    const int32_t* __restrict__ extra) {
  const Place pl = place(N, S);
  Summary<M> tb[2];
  load_table(pl, 1, B, S, sc, true, tb);
  if (!pl.on) return;
  const int n = honest_top<BYZ>(n_real, pl.b, nb);
  const bool ex = BYZ && extra != nullptr;
  const int q5 = 2 * f[pl.b] + 1;
  const long long nodes = static_cast<long long>(pl.b) * N;
  for (int i = pl.i0 + pl.sub; i < pl.i1; i += UNROLL * pl.P) {
    uint8_t bu[UNROLL];
    int32_t xu[UNROLL], du[UNROLL], eu[UNROLL];
    bool p2[UNROLL], com[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int iu = i + u * pl.P;
      const bool in = iu < pl.i1;
      const long long e = (nodes + iu) * S + pl.s;
      bu[u] = in ? bits[nodes + iu] : 0;
      xu[u] = in ? pp_val[e] : 0;
      du[u] = in ? dval[e] : 0;
      p2[u] = in && prep[e];
      com[u] = in && committed[e];
      eu[u] = ex && in ? extra[nodes + iu] : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int iu = i + u * pl.P;
      if (iu >= pl.i1) break;
      const long long e = (nodes + iu) * S + pl.s;
      const uint8_t bi = bu[u];
      const int cnt = lookup(tb, (bi >> 1) & 1, xu[u]) +
                      (iu < n && !(bi & 1) && p2[u]) + eu[u];
      const bool now = p2[u] && cnt >= q5 && !com[u];
      com_out[e] = com[u] || now;
      dval_out[e] = now ? xu[u] : du[u];
    }
  }
}

template <int M, bool CRASH, bool BYZ>
int launch_all(const int32_t* n_real, const int32_t* f, const uint8_t* bits,
               const bool* pp_seen, const int32_t* pp_val,
               const bool* prepared, const bool* committed,
               const int32_t* dval, bool* prep_out, bool* com_out,
               int32_t* dval_out, const Scratch& sc, dim3 grid, int B, int N,
               int S, int nb, const int32_t* extra, cudaStream_t st) {
  int err;
  tally_candidates_kernel<M, false, false, BYZ><<<grid, THREADS, 0, st>>>(
      n_real, f, bits, pp_seen, pp_val, prepared, prep_out, sc, B, N, S, nb,
      extra);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  tally_recount_kernel<M, BYZ><<<grid, THREADS, 0, st>>>(
      n_real, bits, pp_seen, pp_val, sc, 0, B, N, S, nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  tally_candidates_kernel<M, true, CRASH, BYZ><<<grid, THREADS, 0, st>>>(
      n_real, f, bits, pp_seen, pp_val, prepared, prep_out, sc, B, N, S, nb,
      extra);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  tally_recount_kernel<M, BYZ><<<grid, THREADS, 0, st>>>(
      n_real, bits, prep_out, pp_val, sc, 1, B, N, S, nb);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  tally_commit_kernel<M, BYZ><<<grid, THREADS, 0, st>>>(
      n_real, f, bits, pp_val, prep_out, committed, dval, com_out, dval_out,
      sc, B, N, S, nb, extra);
  return static_cast<int>(cudaGetLastError());
}

using LaunchAll = int (*)(const int32_t*, const int32_t*, const uint8_t*,
                          const bool*, const int32_t*, const bool*,
                          const bool*, const int32_t*, bool*, bool*,
                          int32_t*, const Scratch&, dim3, int, int, int, int,
                          const int32_t*, cudaStream_t);

// The instance of width m: 1 or 2 without byzantine nodes, 1 to 4 with.
template <bool CRASH, bool BYZ>
LaunchAll pick(int m) {
  if (m == 1) return launch_all<1, CRASH, BYZ>;
  if (m == 2) return launch_all<2, CRASH, BYZ>;
  if constexpr (BYZ) {
    if (m == 3) return launch_all<3, CRASH, BYZ>;
    if (m == 4) return launch_all<4, CRASH, BYZ>;
  }
  return nullptr;
}

}  // namespace

// scratch is `words` int32 words (engines/pbft_bcast.py
// tally_scratch_ints); its counters are zeroed here. m, the counters a
// summary keeps, is the table width: 1 or 2 without byzantine nodes, up to
// 4 with them. extra, [B, N] int32, is given exactly with byz = BYZ_EQUIV.
extern "C" int ctt_bcast_tally(const int32_t* n_real, const int32_t* f,
                               const uint8_t* bits, const bool* pp_seen,
                               const int32_t* pp_val, const bool* prepared,
                               const bool* committed, const int32_t* dval,
                               bool* prep_out, bool* com_out,
                               int32_t* dval_out, int* scratch,
                               long long words, int m, int B, int N, int S,
                               int crash, int byz, int nb,
                               const int32_t* extra, cudaStream_t st) {
  if (nb < 0 || nb > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV ||
      (byz == ctt::BYZ_EQUIV) != (extra != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool hon = byz != ctt::BYZ_NONE;
  const LaunchAll all = hon ? (crash ? pick<true, true>(m)
                                     : pick<false, true>(m))
                            : (crash ? pick<true, false>(m)
                                     : pick<false, false>(m));
  if (all == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || S == 0) return 0;
  const int nblk = (N + CHUNK - 1) / CHUNK;
  const int SG = S < MAX_SG ? S : MAX_SG;
  const int groups = (S + SG - 1) / SG;
  const long long table = static_cast<long long>(B) * S * 2 * MAX_M;
  const long long zeroed = 2 * table + 2LL * B * groups;
  if (words < zeroed + 2 * 2 * table + 2 * nblk * table)
    return static_cast<int>(cudaErrorInvalidValue);
  Scratch sc;
  sc.counts = scratch;
  sc.done = scratch + 2 * table;
  sc.cand_k = scratch + zeroed;
  sc.cand_c = sc.cand_k + 2 * table;
  sc.summ_k = sc.cand_c + 2 * table;
  sc.summ_c = sc.summ_k + nblk * table;
  const int err = static_cast<int>(cudaMemsetAsync(
      scratch, 0, sizeof(int) * static_cast<size_t>(zeroed), st));
  if (err != 0) return err;
  if (static_cast<long long>(nblk) * B > 0x7FFFFFFFLL || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblk * B), 1u,
                  static_cast<unsigned>(groups));
  return all(n_real, f, bits, pp_seen, pp_val, prepared, committed, dval,
             prep_out, com_out, dval_out, sc, grid, B, N, S, nb, extra, st);
}
