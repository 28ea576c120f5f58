// Kernel KAM: the SPEC §9 segment combine of one PBFT switch phase, for
// every lane: what each aggregator serves, per (lane, aggregator, slot).
//
// Replaces: consensus_tpu/ops/aggregate.py (K21) value_votes' combine (lines
// 415-435) and min_id_votes' (472-486), with seg_sum, seg_max, seg_min and
// the traced _seg_reduce (216-255), seg_widths (181-187) and uplink_lies
// (154-178), as engines/pbft.py pbft_round (K16, lines 264-353),
// pbft_bcast.py pbft_bcast_round (K15, 553-640) and pbft_sweep.py
// _padded_switch_phases (K17, 61-135) call them. Aggregator a of lane b
// combines the senders of its segment [a * seg, min((a + 1) * seg, n_real))
// with seg = ceil(n_real / K) (the f-ladder's segmentation; the standalone
// engines' at n_real = N); a sender is live where it is honest (i < n_real
// - nb), its phase flag is set (pp_seen in P4, prepared after P4 in P5,
// committed after P5 in P6) and its uplink in KAL's mask row of the phase
// is open. In the vote phases (P4, P5) the combine is the live count cnt
// and the extremes vmax, vmin of the senders' pp_val, with each byzantine
// member's SPEC §9b lie (a live uplink, draw(POISON, r, 1, i) < lie_cut)
// counted in and its forged value bitcast(draw(POISON, r, 2, i)) folded
// into the extremes (empty: I32_MIN, I32_MAX); the aggregator serves where
// cnt > 0 and vmax == vmin, and then tot = cnt + eqc, the byzantine members
// whose per-round stance draw(EQUIV, r, i, 0x80000000) & 1 is set and whose
// uplink is open (0 without equivocation); tot is 0 where it does not
// serve, val is vmax. In the decide phase (P6) it is the least live id, N
// where there is none (min_id_votes' identity N_pad).
//
// Bound: bytes. The function reads each (sender, slot) flag and, in a vote
// phase, its pp_val once (5 bytes), and a byte a sender of the uplink row;
// at pbft-100k-bcast (B = 8, N = 100 000, S = 16) that is 65 MB, 19 us at
// 3.35 TB/s; the tables written are 2 KB a lane.
// Design: two launches. The first: a block per (lane, aggregator, chunk of
// the segment's rows, group of 256 slots); the block's threads are
// THREADS / Sp rows of Sp = min(S, 256) consecutive slots, so consecutive
// threads read consecutive bytes; each thread walks its rows of the chunk
// (a vote phase without branches, four rows' loads in flight; the decide
// phase up to its first live sender, its least) and the
// block reduces its rows in shared memory into one partial a slot; the
// block of slot group 0 also walks the chunk's byzantine members (a thread
// a member) for the lies' and the support's terms, reduced by a shared tree.
// The second: a thread per (lane, aggregator, slot) folds the chunks'
// partials and writes the served table. No atomics; every partial cell is
// written, so nothing is zeroed.
// Its KNOBS instance (a knob batch: the table pointer is not null,
// knobs.cuh) reads each lane's §9b uplink-lie cutoff from the lane's row of
// the table in place of the argument, where the base lies at all (the
// prepare and commit phases; the decide phase draws no lie).
#include <cuda_runtime.h>

#include <cstdint>

#include "agg.cuh"
#include "byz.cuh"
#include "knobs.cuh"

namespace {

constexpr int THREADS = 256;
// (sender, slot) elements a block of the first launch covers.
constexpr int ELEMS = 16384;
constexpr int32_t I32_MAX = 0x7FFFFFFF;
constexpr int32_t I32_MIN = -I32_MAX - 1;
// Words of a vote phase's (lane, aggregator, chunk, slot) partial: count,
// max, min; of its (lane, aggregator, chunk) byzantine partial: the liars'
// count, max and min, the supporting equivocators' count.
constexpr int SLOT_WORDS = 3;
constexpr int NODE_WORDS = 4;

struct Geo {
  int N, S, K, Sp, rows, chunks, groups;
};

Geo geometry(int N, int S, int K) {
  Geo g;
  g.N = N;
  g.S = S;
  g.K = K;
  g.Sp = S < THREADS ? S : THREADS;
  g.rows = ELEMS / g.Sp;
  const int seg = ctt::agg_seg(N, K);  // the widest lane's segment
  g.chunks = (seg + g.rows - 1) / g.rows;
  g.groups = (S + g.Sp - 1) / g.Sp;
  return g;
}

template <bool DECIDE, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
switch_combine_rows(const uint32_t* __restrict__ seed, uint32_t r,
                    const int32_t* __restrict__ n_real,
                    const bool* __restrict__ flag,
                    const int32_t* __restrict__ vals,
                    const bool* __restrict__ up, int up_rows, int up_row,
                    int32_t* __restrict__ part, int32_t* __restrict__ node_part,
                    Geo g, int nb, bool equiv, uint32_t lie_cut,
                    const long long* __restrict__ knobs) {
  __shared__ int32_t sh[NODE_WORDS][THREADS];
  const int c = blockIdx.x % g.chunks;
  const int ba = blockIdx.x / g.chunks;  // lane * K + aggregator
  const int a = ba % g.K;
  const int b = ba / g.K;
  const int nr = n_real[b];
  const int seg = ctt::agg_seg(nr, g.K);
  const int lo = a * seg + c * g.rows;
  const int hi = min(min((a + 1) * seg, nr), lo + g.rows);
  const int n_hon = nr - nb;
  const bool* upl =
      up + (static_cast<long long>(b) * up_rows + up_row) * g.N;
  const int t = static_cast<int>(threadIdx.x);
  const int R = THREADS / g.Sp;
  const int row = t / g.Sp;
  const int col = t - row * g.Sp;
  const int s = static_cast<int>(blockIdx.y) * g.Sp + col;
  const bool on = row < R && s < g.S;
  int cnt = 0;
  int32_t vmax = I32_MIN, vmin = DECIDE ? g.N : I32_MAX;
  if (on) {
    const int end = min(hi, n_hon);  // honest senders only
    if (DECIDE) {
      for (int i = lo + row; i < end; i += R) {
        const long long e = (static_cast<long long>(b) * g.N + i) * g.S + s;
        if (flag[e] && upl[i]) {
          vmin = i;  // a thread's rows ascend: its first live one is least
          break;
        }
      }
    } else {
      // Branch-free, unrolled: the loads of four rows are in flight at
      // once.
#pragma unroll 4
      for (int i = lo + row; i < end; i += R) {
        const long long e = (static_cast<long long>(b) * g.N + i) * g.S + s;
        const bool live = flag[e] && upl[i];
        const int32_t v = vals[e];
        cnt += live;
        vmax = max(vmax, live ? v : I32_MIN);
        vmin = min(vmin, live ? v : I32_MAX);
      }
    }
  }
  sh[0][t] = cnt;
  sh[1][t] = vmax;
  sh[2][t] = vmin;
  for (int off = 1; off < R; off <<= 1) {
    __syncthreads();
    if (on && row % (2 * off) == 0 && row + off < R) {
      const int u = t + off * g.Sp;
      sh[0][t] += sh[0][u];
      sh[1][t] = max(sh[1][t], sh[1][u]);
      sh[2][t] = min(sh[2][t], sh[2][u]);
    }
  }
  __syncthreads();
  const long long cell = static_cast<long long>(ba) * g.chunks + c;
  if (on && row == 0) {
    if (DECIDE) {
      part[cell * g.S + s] = sh[2][t];
    } else {
      int32_t* p = part + (cell * g.S + s) * SLOT_WORDS;
      p[0] = sh[0][t];
      p[1] = sh[1][t];
      p[2] = sh[2][t];
    }
  }
  if (DECIDE || blockIdx.y != 0) return;
  // The chunk's byzantine members: their lies and equivocating support. A
  // knob batch's lane reads its lie cutoff here, after the slot sums,
  // where the base lies at all.
  if (KNOBS && lie_cut != 0u)
    lie_cut = ctt::knob(knobs, b, ctt::KNOB_BYZ_UPLINK);
  int lies = 0, support = 0;
  int32_t lmax = I32_MIN, lmin = I32_MAX;
  const uint32_t sd = seed[b];
  for (int i = max(lo, n_hon) + t; i < hi; i += THREADS) {
    if (!upl[i]) continue;
    const uint32_t ui = static_cast<uint32_t>(i);
    if (lie_cut != 0u && ctt::uplink_lie(sd, r, ui, lie_cut)) {
      ++lies;
      const int32_t v = static_cast<int32_t>(
          ctt::random_u32(sd, ctt::STREAM_POISON, r, 2u, ui));
      lmax = max(lmax, v);
      lmin = min(lmin, v);
    }
    if (equiv && ctt::equiv_stance(sd, r, ui, 0x80000000u)) ++support;
  }
  __syncthreads();
  sh[0][t] = lies;
  sh[1][t] = lmax;
  sh[2][t] = lmin;
  sh[3][t] = support;
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    __syncthreads();
    if (t < off) {
      sh[0][t] += sh[0][t + off];
      sh[1][t] = max(sh[1][t], sh[1][t + off]);
      sh[2][t] = min(sh[2][t], sh[2][t + off]);
      sh[3][t] += sh[3][t + off];
    }
  }
  if (t == 0) {
    int32_t* p = node_part + cell * NODE_WORDS;
    for (int k = 0; k < NODE_WORDS; ++k) p[k] = sh[k][0];
  }
}

template <bool DECIDE>
__global__ void __launch_bounds__(THREADS)
switch_combine_fold(const int32_t* __restrict__ part,
                    const int32_t* __restrict__ node_part,
                    int32_t* __restrict__ out,
                    int32_t* __restrict__ out_val, Geo g, long long cells) {
  const long long x =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (x >= cells) return;
  const int s = static_cast<int>(x % g.S);
  const long long ba = x / g.S;
  if (DECIDE) {
    int32_t m = g.N;
    for (int c = 0; c < g.chunks; ++c)
      m = min(m, part[(ba * g.chunks + c) * g.S + s]);
    out[x] = m;
    return;
  }
  int cnt = 0, support = 0;
  int32_t vmax = I32_MIN, vmin = I32_MAX;
  for (int c = 0; c < g.chunks; ++c) {
    const int32_t* p = part + ((ba * g.chunks + c) * g.S + s) * SLOT_WORDS;
    const int32_t* q = node_part + (ba * g.chunks + c) * NODE_WORDS;
    cnt += p[0] + q[0];
    vmax = max(vmax, max(p[1], q[1]));
    vmin = min(vmin, min(p[2], q[2]));
    support += q[3];
  }
  const bool serve = cnt > 0 && vmax == vmin;
  out[x] = serve ? cnt + support : 0;
  out_val[x] = vmax;
}

}  // namespace

// flag [B, N, S] bool, vals [B, N, S] int32 (null in the decide phase), up
// [B, up_rows, N] bool (KAL's uplinks; row up_row is the phase's). Outputs
// [B, K, S] int32: out (tot, or the least live id) and out_val (val; null
// in the decide phase). scratch is int32 words, as ops/switch_tally.py
// combine_scratch_ints counts them. lie_cut is 0 without §9b lies. knobs
// is a knob batch's [B, 12] table (knobs.cuh; null but in a knob batch):
// lie_cut is then the base's, 0 where the base lies not, and each lane
// reads its own from its row.
extern "C" int ctt_switch_combine(const uint32_t* seed, uint32_t r,
                                  const int32_t* n_real, const bool* flag,
                                  const int32_t* vals, const bool* up,
                                  int32_t* out, int32_t* out_val,
                                  int32_t* scratch, int up_rows, int up_row,
                                  int B, int N, int S, int K, int decide,
                                  int nb, int equiv, uint32_t lie_cut,
                                  const long long* knobs, cudaStream_t st) {
  if (K < 1 || K > N || S < 1 || nb < 0 || nb > N || up_rows < 1 ||
      up_row < 0 || up_row >= up_rows || (decide == 0) != (vals != nullptr) ||
      (decide == 0) != (out_val != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Geo g = geometry(N, S, K);
  const long long blocks = static_cast<long long>(B) * K * g.chunks;
  const long long cells = static_cast<long long>(B) * K * S;
  if (blocks > 0x7FFFFFFFLL || g.groups > 65535 ||
      (cells + THREADS - 1) / THREADS > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(g.groups));
  const unsigned fold = static_cast<unsigned>((cells + THREADS - 1) / THREADS);
  if (decide != 0) {
    switch_combine_rows<true, false><<<grid, THREADS, 0, st>>>(
        seed, r, n_real, flag, vals, up, up_rows, up_row, scratch, nullptr, g,
        nb, false, 0u, nullptr);
    switch_combine_fold<true><<<fold, THREADS, 0, st>>>(
        scratch, nullptr, out, nullptr, g, cells);
  } else {
    int32_t* node_part = scratch + blocks * S * SLOT_WORDS;
    const auto rows = knobs != nullptr ? switch_combine_rows<false, true>
                                       : switch_combine_rows<false, false>;
    rows<<<grid, THREADS, 0, st>>>(seed, r, n_real, flag, vals, up, up_rows,
                                   up_row, scratch, node_part, g, nb,
                                   equiv != 0, lie_cut, knobs);
    switch_combine_fold<false><<<fold, THREADS, 0, st>>>(
        scratch, node_part, out, out_val, g, cells);
  }
  return static_cast<int>(cudaGetLastError());
}
