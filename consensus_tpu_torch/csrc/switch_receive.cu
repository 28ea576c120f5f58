// Kernel KAN: the SPEC §9 receiver pass of one PBFT switch phase, for every
// (lane, node, slot): the K served combines (kernel KAM's tables) a
// receiver gets through its downlinks, its threshold, and in the decide
// phase the adoption and the round's timers.
//
// Replaces: consensus_tpu/ops/aggregate.py (K21) downlink (lines 326-345),
// downlink_self (348-372), value_votes' receiver pass (436-469) and
// min_id_votes' (487-504), and the P4-P7 tails that engines/pbft.py
// pbft_round (K16, lines 302-366), pbft_bcast.py pbft_bcast_round (K15,
// 598-675) and pbft_sweep.py _padded_switch_phases (K17, 110-135) build on
// them. Aggregator a of phase ph reaches receiver j where it is alive, the
// §2 draw (r, g, j) of vertex g = n_real + ph * K + a is open (or a dropped
// flight of the last max_delay rounds arrives) and, in a round whose
// partition is active, j is on the side of vertex n_real + a (KAL's table
// word; ctt::agg_downlink). In a vote phase (P4 prepare, P5 commit) the
// receiver's count of slot s is the sum over its delivered aggregators of
// tot[a, s] where val[a, s] equals its own pp_val (or, where a is poisoned
// in this phase under §9b, a's segment width, whatever the values), less
// its own returned copy exactly as value_votes subtracts it (lines
// 451-468), plus its own vote (honest and flagged); the slot passes at
// 2 f + 1: out = base | (flag & pass), with P5's decided value taken where
// it commits (flag & pass & ~base). With the §6c flag word (the §6b round's
// P4) a receiver down at the round's end takes nothing. In the decide
// phase (P6) the receiver adopts, into a slot it has not committed, the
// decided value of the least id its delivered aggregators serve
// (dval[imin, s]: the value min_id_votes' winning combine carries), and
// P7 sets the timers of the round (0 after a new commit, kept after a
// reset, else counted up).
//
// Bound: bytes. A vote phase reads pp_val, the flag and the base flag of
// each (node, slot) and writes the result (7 bytes; P5 also reads and
// writes dval, 15), the decide phase reads committed, committed at entry
// and dval and writes two (10 bytes): at pbft-100k-bcast (B = 8,
// N = 100 000, S = 16) 90, 192 and 128 MB, 27, 57 and 38 us at
// 3.35 TB/s; K downlink draws a receiver are 2e8 operations, 6 us.
// Design: two launches. The first: a thread per (lane, receiver, 32
// aggregators) draws those downlinks into a bit word of a [B, N, ceil(K /
// 32)] scratch mask. The second: a block per (lane, THREADS / Sp receivers),
// a thread per group of L consecutive slots of a receiver (L = 4 where S is
// a multiple of 4, so its loads and stores are 16 or 4 bytes wide; Sp =
// min(S / L, 256) groups at a time), so consecutive threads read
// consecutive cells; the block first stages its lane's served tables in
// shared memory (where K * S fits), then a thread walks its groups and, a
// group, the set bits of its receiver's downlink words (the delivered
// aggregators only) and their table entries for its L slots; in the decide
// phase the receiver's new commits meet in a shared flag and its first
// thread writes its timer. Fresh outputs throughout. The first version (a
// thread a cell, the tables read from global memory a cell and
// aggregator) took 303, 320, 231 us at pbft-100k-bcast on an H100 80GB
// HBM3 at 700 W, this one 118, 130, 96 (PERF.md).
// Its KNOBS instance (a knob batch: the table pointer is not null,
// knobs.cuh) reads each lane's drop and partition cutoffs from the lane's
// row of the table in place of the arguments (launch 1, the downlink mask;
// launch 2 reads no cutoff).
#include <cuda_runtime.h>

#include <cstdint>

#include "agg.cuh"
#include "byz.cuh"
#include "crash.cuh"
#include "knobs.cuh"

namespace {

constexpr int THREADS = 256;

template <bool KNOBS>
__global__ void __launch_bounds__(THREADS)
switch_downlink_mask(const uint32_t* __restrict__ seed, uint32_t r,
                     const int32_t* __restrict__ n_real,
                     const int32_t* __restrict__ tab,
                     uint32_t* __restrict__ mask,
                     int N, int K, int W, int ph, uint32_t drop_cut,
                     uint32_t part_cut, uint32_t max_delay, long long words,
                     const long long* __restrict__ knobs) {
  const long long x =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (x >= words) return;
  const int w = static_cast<int>(x % W);
  const long long bj = x / W;
  const int j = static_cast<int>(bj % N);
  const long long b = bj / N;
  if (KNOBS) {
    drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
  }
  const uint32_t sd = seed[b];
  const uint32_t base = static_cast<uint32_t>(n_real[b]);
  const bool part = ctt::part_on(sd, r, part_cut);
  const uint32_t uj = static_cast<uint32_t>(j);
  const uint32_t side = part ? ctt::part_side(sd, r, uj) : 0u;
  uint32_t bits = 0u;
  const int a_end = min(K, 32 * w + 32);
  for (int a = 32 * w; a < a_end; ++a) {
    const uint32_t g = base + static_cast<uint32_t>(ph * K + a);
    if (ctt::agg_downlink(sd, r, ctt::downlink_prefix(sd, r, g), g, uj,
                          tab[b * K + a], drop_cut, max_delay, part, side))
      bits |= 1u << (a - 32 * w);
  }
  mask[x] = bits;
}

struct Recv {
  const int32_t* n_real;
  const int32_t* f;
  const int32_t* tab;
  const int32_t* tot;  // tot, or the least ids in the decide phase
  const int32_t* val;
  const bool* flag;
  const int32_t* vals;
  const bool* up;  // the phase's uplink row of lane 0; lane stride up_stride
  long long up_stride;
  const bool* base;
  const int32_t* dval_in;
  int32_t* dval_out;
  bool* out;
  const bool* committed_start;
  const int32_t* timer;
  const bool* reset;
  int32_t* timer_out;
  const unsigned char* flags;
  const uint32_t* mask;
  int N, S, K, W, ph, nb, Sp, tiles;
  bool equiv, poison, staged;
};

// The lane's served tables, staged in dynamic shared memory where they fit
// (MAX_STAGED words), else read from global memory: a block serves one
// lane.
constexpr int MAX_STAGED = 12288;

// L consecutive int32 or bool cells (L = 4: one 16-byte or 4-byte access;
// the caller keeps the address aligned).
template <int L>
__device__ __forceinline__ void load_cells(const int32_t* p, int32_t (&x)[L]) {
  if constexpr (L == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = *p;
  }
}

template <int L>
__device__ __forceinline__ void load_cells(const bool* p, bool (&x)[L]) {
  if constexpr (L == 4) {
    const uchar4 q = *reinterpret_cast<const uchar4*>(p);
    x[0] = q.x != 0;
    x[1] = q.y != 0;
    x[2] = q.z != 0;
    x[3] = q.w != 0;
  } else {
    x[0] = *p;
  }
}

template <int L>
__device__ __forceinline__ void store_cells(int32_t* p, const int32_t (&x)[L]) {
  if constexpr (L == 4)
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

template <int L>
__device__ __forceinline__ void store_cells(bool* p, const bool (&x)[L]) {
  if constexpr (L == 4)
    *reinterpret_cast<uchar4*>(p) = make_uchar4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// A thread takes L consecutive slots of one receiver at a time (L = 4 where
// S is a multiple of 4, else 1): its loads are 16 or 4 bytes wide, and the
// walk over its receiver's delivered aggregators serves L cells.
template <bool DECIDE, int L>
__global__ void __launch_bounds__(THREADS)
switch_receive_kernel(const uint32_t* __restrict__ seed, uint32_t r, Recv p) {
  __shared__ int newc[THREADS];
  extern __shared__ int4 staged_words[];
  int32_t* staged = reinterpret_cast<int32_t*>(staged_words);
  const int b = static_cast<int>(blockIdx.x) / p.tiles;
  const int tile = static_cast<int>(blockIdx.x) - b * p.tiles;
  const int t = static_cast<int>(threadIdx.x);
  const int G = p.S / L;  // slot groups a receiver
  const int R = THREADS / p.Sp;
  const int row = t / p.Sp;
  const int col = t - row * p.Sp;
  const int j = tile * R + row;
  const bool on = row < R && j < p.N;
  const int cells = p.K * p.S;
  const long long row0 = static_cast<long long>(b) * cells;
  const int32_t* T = p.tot + row0;  // tot, or the least ids
  const int32_t* U = DECIDE ? nullptr : p.val + row0;
  if (p.staged) {
    for (int x = t; x < cells; x += THREADS) {
      staged[x] = T[x];
      if (!DECIDE) staged[cells + x] = U[x];
    }
    T = staged;
    U = staged + cells;
  }
  if (DECIDE) newc[t] = 0;
  __syncthreads();
  if (on) {
    const long long bj = static_cast<long long>(b) * p.N + j;
    const uint32_t* mk = p.mask + bj * p.W;
    const int nr = p.n_real[b];
    const int seg = ctt::agg_seg(nr, p.K);
    const int a_own = min(j / seg, p.K - 1);
    const bool keep =
        p.flags == nullptr || !ctt::crash_down(p.flags, b, p.N, j);
    const int32_t* tb = p.tab + static_cast<long long>(b) * p.K;
    if (DECIDE) {
      bool fresh = false;
      for (int g = col; g < G; g += p.Sp) {
        const int s0 = g * L;
        const long long e = bj * p.S + s0;
        int32_t imin[L];
        for (int k = 0; k < L; ++k) imin[k] = p.N;
        for (int w = 0; w < p.W; ++w) {
          for (uint32_t bits = mk[w]; bits != 0u; bits &= bits - 1u) {
            const int a = 32 * w + __ffs(bits) - 1;
            int32_t m[L];
            load_cells<L>(T + a * p.S + s0, m);
            for (int k = 0; k < L; ++k) imin[k] = min(imin[k], m[k]);
          }
        }
        bool com[L], start[L], done[L];
        int32_t d[L];
        load_cells<L>(p.base + e, com);
        load_cells<L>(p.committed_start + e, start);
        load_cells<L>(p.dval_in + e, d);
        for (int k = 0; k < L; ++k) {
          const bool adopt = imin[k] < p.N && !com[k] && keep;
          if (adopt)
            d[k] = p.dval_in[(static_cast<long long>(b) * p.N + imin[k]) *
                                 p.S + s0 + k];
          done[k] = com[k] || adopt;
          fresh |= done[k] && !start[k];
        }
        store_cells<L>(p.dval_out + e, d);
        store_cells<L>(p.out + e, done);
      }
      if (fresh) newc[row] = 1;
    } else {
      const bool hon = j < nr - p.nb;
      const bool up_j = p.up[b * p.up_stride + j];
      const bool eq_up = p.equiv && !hon && j < nr && up_j &&
                         ctt::equiv_stance(seed[b], r, static_cast<uint32_t>(j),
                                           0x80000000u);
      const int32_t pz_bit = ctt::AGG_POISON0 << p.ph;
      const bool down_own = (mk[a_own >> 5] >> (a_own & 31)) & 1u;
      const bool pz_own = p.poison && down_own && (tb[a_own] & pz_bit) != 0;
      const int32_t q = 2 * p.f[b] + 1;
      for (int g = col; g < G; g += p.Sp) {
        const int s0 = g * L;
        const long long e = bj * p.S + s0;
        int32_t v[L];
        bool fl[L], bv[L];
        load_cells<L>(p.vals + e, v);
        load_cells<L>(p.flag + e, fl);
        load_cells<L>(p.base + e, bv);
        int c[L];
        for (int k = 0; k < L; ++k) c[k] = 0;
        for (int w = 0; w < p.W; ++w) {
          for (uint32_t bits = mk[w]; bits != 0u; bits &= bits - 1u) {
            const int a = 32 * w + __ffs(bits) - 1;
            if (p.poison && (tb[a] & pz_bit) != 0) {
              const int width = max(0, min((a + 1) * seg, nr) - a * seg);
              for (int k = 0; k < L; ++k) c[k] += width;
              continue;
            }
            int32_t tt[L], vv[L];
            load_cells<L>(T + a * p.S + s0, tt);
            load_cells<L>(U + a * p.S + s0, vv);
            for (int k = 0; k < L; ++k)
              if (tt[k] > 0 && vv[k] == v[k]) c[k] += tt[k];
          }
        }
        int32_t to[L], vo[L];
        load_cells<L>(T + a_own * p.S + s0, to);
        load_cells<L>(U + a_own * p.S + s0, vo);
        bool res[L], commit[L];
        for (int k = 0; k < L; ++k) {
          const bool contrib = hon && fl[k];
          const bool own_hit = down_own && to[k] > 0 && vo[k] == v[k];
          int sub = contrib && up_j && own_hit;
          int eq_sub = eq_up && own_hit;
          if (pz_own) {
            sub = contrib;
            eq_sub = 0;
          }
          const bool pass = c[k] - sub - eq_sub + contrib >= q;
          res[k] = bv[k] || (fl[k] && pass && keep);
          commit[k] = fl[k] && pass && !bv[k];
        }
        store_cells<L>(p.out + e, res);
        if (p.dval_out != nullptr) {
          int32_t d[L];
          load_cells<L>(p.dval_in + e, d);
          for (int k = 0; k < L; ++k)
            if (commit[k]) d[k] = v[k];
          store_cells<L>(p.dval_out + e, d);
        }
      }
    }
  }
  if (!DECIDE) return;
  __syncthreads();
  if (on && col == 0) {
    const long long bj = static_cast<long long>(b) * p.N + j;
    const bool fresh = newc[row] != 0;
    p.timer_out[bj] = p.reset[bj] || fresh ? (fresh ? 0 : p.timer[bj])
                                           : p.timer[bj] + 1;
  }
}

}  // namespace

// tab [B, K] (KAL's words), tot and val [B, K, S] (KAM's tables; the
// decide phase: tot holds the least ids, val is null). A vote phase (0, 1)
// reads flag, vals ([B, N, S]) and KAL's uplinks up ([B, up_rows, N], row
// up_row), and writes out = base | (flag & pass) and, where dval_in is
// given (P5), dval_out; the decide phase (2) reads base (committed after
// P5), dval_in, committed_start, timer and reset and writes out, dval_out
// and timer_out. flags (the §6c word) is null but where a down receiver
// takes nothing. mask is [B, N, ceil(K / 32)] uint32 scratch. knobs is a
// knob batch's [B, 12] table (knobs.cuh; null but in a knob batch): the
// drop and partition cutoffs are then the base's and each lane reads its
// own from its row.
extern "C" int ctt_switch_receive(
    const uint32_t* seed, uint32_t r, const int32_t* n_real, const int32_t* f,
    const int32_t* tab, const int32_t* tot, const int32_t* val,
    const bool* flag, const int32_t* vals, const bool* up, int up_rows,
    int up_row, const bool* base, const int32_t* dval_in, int32_t* dval_out,
    bool* out, const bool* committed_start, const int32_t* timer,
    const bool* reset, int32_t* timer_out, const unsigned char* flags,
    uint32_t* mask, int B, int N, int S, int K, int phase, int nb, int equiv,
    int poison, uint32_t drop_cut, uint32_t part_cut, uint32_t max_delay,
    const long long* knobs, cudaStream_t st) {
  const bool decide = phase == 2;
  if (K < 1 || K > N || S < 1 || phase < 0 || phase > 2 || nb < 0 ||
      nb > N || (!decide && (val == nullptr || flag == nullptr ||
                             vals == nullptr || up == nullptr ||
                             up_row < 0 || up_row >= up_rows ||
                             (dval_in == nullptr) != (dval_out == nullptr))) ||
      (decide && (dval_in == nullptr || dval_out == nullptr ||
                  committed_start == nullptr || timer == nullptr ||
                  reset == nullptr || timer_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int W = (K + 31) / 32;
  const long long mask_words = static_cast<long long>(B) * N * W;
  const int L = S % 4 == 0 ? 4 : 1;  // slots a thread takes at a time
  const int Sp = S / L < THREADS ? S / L : THREADS;
  const int tiles = (N + THREADS / Sp - 1) / (THREADS / Sp);
  const long long blocks = static_cast<long long>(B) * tiles;
  if ((mask_words + THREADS - 1) / THREADS > 0x7FFFFFFFLL ||
      blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned mask_grid =
      static_cast<unsigned>((mask_words + THREADS - 1) / THREADS);
  const auto downlinks = knobs != nullptr ? switch_downlink_mask<true>
                                           : switch_downlink_mask<false>;
  downlinks<<<mask_grid, THREADS, 0, st>>>(seed, r, n_real, tab, mask, N, K,
                                           W, phase, drop_cut, part_cut,
                                           max_delay, mask_words, knobs);
  Recv p;
  p.n_real = n_real;
  p.f = f;
  p.tab = tab;
  p.tot = tot;
  p.val = val;
  p.flag = flag;
  p.vals = vals;
  p.up = decide ? nullptr : up + static_cast<long long>(up_row) * N;
  p.up_stride = static_cast<long long>(up_rows) * N;
  p.base = base;
  p.dval_in = dval_in;
  p.dval_out = dval_out;
  p.out = out;
  p.committed_start = committed_start;
  p.timer = timer;
  p.reset = reset;
  p.timer_out = timer_out;
  p.flags = flags;
  p.mask = mask;
  p.N = N;
  p.S = S;
  p.K = K;
  p.W = W;
  p.ph = phase;
  p.nb = nb;
  p.Sp = Sp;
  p.tiles = tiles;
  p.equiv = equiv != 0;
  p.poison = poison != 0 && phase < 2;
  const long long words =
      static_cast<long long>(K) * S * (decide ? 1 : 2);
  p.staged = words <= MAX_STAGED;
  const size_t smem = p.staged ? sizeof(int32_t) * words : 0;
  const unsigned grid = static_cast<unsigned>(blocks);
  const auto kernel =
      decide ? (L == 4 ? switch_receive_kernel<true, 4>
                       : switch_receive_kernel<true, 1>)
             : (L == 4 ? switch_receive_kernel<false, 4>
                       : switch_receive_kernel<false, 1>);
  kernel<<<grid, THREADS, smem, st>>>(seed, r, p);
  return static_cast<int>(cudaGetLastError());
}
