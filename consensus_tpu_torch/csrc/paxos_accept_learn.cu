// Kernel KZ: SPEC §5 Paxos phases 3-6 of one round at every (acceptor,
// proposer) pair of each lane: each proposer's gate and value, the
// accepts, the accepted responses and decisions, the decide broadcast and
// learning.
//
// Replaces: consensus_tpu/engines/paxos.py paxos_round (K19) lines 182-250
// on its flat path (no crash, no switch). Phase 3: p proceeds when it
// proposes and n_prom[p] >= N // 2 + 1; v_chosen[p] = acc_val[best_a,
// slot_p] if best_bal > 0, else its own draw. Phase 4: at acceptor a,
// a_max[a, s] is the largest ballot (at least 0) of a proceeding proposer
// on s whose accept reached a with ballot >= new_promised[a, s]; the
// proposer holding it wins, and where a_max > 0 acc_bal, acc_val and
// promised become (a_max, its value, a_max), else they keep acc_bal, acc_val
// and new_promised. Phase 5: p decides when it proceeds and the acceptors
// it won whose responses reached it are a majority. Phase 6: node n learns
// slot s, where it has not, from the lowest-id decider on s whose decide
// reached n or that is n; learned_mask marks every slot such a decider
// reached.
//
// Bound: bytes, counting each tensor once: the mask in both orientations
// (2 bytes a pair), new_promised, acc_bal, acc_val and learned_val read
// and four int32 outputs written, learned_mask read and written (34 bytes
// a (row, slot)). At paxos-10kx10k (B = 1, N = S = 10 000) that is
// 3.6 GB, 1.1 ms at 3.35 TB/s.
// Design: three launches. Only proceeding proposers take part in phases
// 4-6, and at the flagship about 1 - 1/e of the slots hold one of them and
// the rest none, so each lane's proceeding proposers are bucketed by slot
// once and every (row, slot) cell walks its own bucket.
//  1. A cluster of up to 8 blocks a lane: each proposer's gate, its n_acc
//     zeroed, and for a proceeding one its slot, ballot and value (reading
//     acc_val of another acceptor before any row is written: every output
//     is a fresh tensor); a counting sort of them by slot (a histogram, a
//     scan, a scatter by atomics on the starts; the order inside a bucket
//     is free, since the walks take a maximum or a minimum by value) into
//     the lane's list (id, with its partition side in bit 31 on a switch
//     round; ballot; value) and bucket starts [S + 1]. The starts live in
//     the first block's shared memory, which the others reach through the
//     cluster, where they fit, else in the starts' own rows.
//  2. Accept: G blocks a lane (enough to fill the card, from the occupancy
//     calculator), each walking rows j, j + G, ...: the row's prep_del and
//     deliver bytes are staged in shared memory with 16-byte loads, then
//     each thread takes V (4 where the rows allow) consecutive slots with
//     16-byte loads and stores of new_promised, acc_bal and acc_val and of
//     the three outputs, walks each slot's bucket for the maximum eligible
//     ballot (from 0) and its holder (ballots of a round are distinct, so
//     at most one), and counts a winner's delivered response at its list
//     position. A thread keeps the same slots in every row, so it alone
//     owns those counts: plain shared-memory adds, merged into n_acc by one
//     integer atomic a (block, proceeding proposer) at the end.
//  3. Learn: the same grid over receiver rows: each block first reads the
//     decided flags of the list (n_acc >= N // 2 + 1) into shared memory,
//     then per (row, slot) walks the bucket for the lowest decider that
//     reached the row, with the same wide accesses. The lane's first block
//     also turns the proceed flags into decided flags (the counts'
//     companion output).
// Where a row's bytes and the list's counts do not fit in shared memory
// (N above ~40 000), the launches read the mask rows and n_acc in device
// memory and count with atomics there; the bucket starts likewise.
// Its SWITCH instance (SPEC §9, picked when kernel KAL's uplink masks and
// aggregator table are given; paxos.py:209-218) changes launches 1 and 2:
// an accepted response travels over the switch in phase 1 instead of
// deliver[a, p], when a's phase-1 uplink is open (KAL's mask, a down
// acceptor already cut) and its aggregator's downlink to p is open
// (ctt::agg_downlink, drawn only for a winning accept; the aggregator's
// prefix once a row, p's partition side once a call in launch 1).
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's churn cutoff from the lane's row of the
// table in place of the argument (launch 1), and on a switch round
// (paxos.py:153-176 under a KnobView) its drop and partition cutoffs for
// the downlink draws (launches 1 and 2); launch 3 reads no cutoff.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "agg.cuh"
#include "knobs.cuh"
#include "paxos.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int GATE_THREADS = 1024;
constexpr int GATE_CLUSTER = 8;  // blocks a lane (portable cluster size)
constexpr int ROW_THREADS = 512;
// Rows of the [B, ROWS, N] int32 scratch: the list by position (id | side
// << 31, ballot, value), the flags by proposer (proceed, then decided; the
// wrapper's counts output), and each proceeding proposer's slot and value
// until the scatter.
constexpr int LIST_ID = 0;
constexpr int LIST_BALLOT = 1;
constexpr int FLAG = ctt::PROP_FLAG;
constexpr int LIST_VALUE = 3;
constexpr int SLOT = 4;
constexpr int VALUE = 5;
constexpr int ROWS = 6;
constexpr int32_t ID_MASK = 0x7FFFFFFF;

// An exclusive prefix sum of a[0, n) in place, by every thread of the
// block (blockDim.x a multiple of 32): each thread sums a contiguous chunk,
// the chunk sums are scanned by warp shuffles, and each chunk is rewritten.
__device__ void block_exclusive_scan(int32_t* a, int n) {
  __shared__ int32_t warp_sum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * chunk), hi = min(n, lo + chunk);
  int32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int32_t x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int32_t run = x - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int32_t c = a[i];
    a[i] = run;
    run += c;
  }
}

// Launch 1. A cluster of GATE_CLUSTER blocks at most a lane, flattened
// into x; block `rank` takes the proposers [rank chunk, (rank + 1) chunk).
// h is the lane's [S + 1] bucket starts: in the first block's shared
// memory (copied out last) or in off itself.
template <bool SWITCH, bool KNOBS>
__global__ void __launch_bounds__(GATE_THREADS)
paxos_gate_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                  const int32_t* __restrict__ n_prom,
                  const int32_t* __restrict__ best_bal,
                  const int32_t* __restrict__ best_a,
                  const int32_t* __restrict__ acc_val,
                  int32_t* __restrict__ props, int32_t* __restrict__ off,
                  int32_t* __restrict__ n_acc, int P, uint32_t churn_cut,
                  uint32_t part_cut, int N, int S, int chunk, bool in_smem,
                  const long long* __restrict__ knobs) {
  extern __shared__ int32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  const int t = threadIdx.x, T = blockDim.x;
  const uint32_t sd = seed[b];
  if (KNOBS) {
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    if (SWITCH) part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
  }
  int32_t* lane = props + static_cast<long long>(b) * ROWS * N;
  int32_t* h = !in_smem ? off + static_cast<long long>(b) * (S + 1)
               : rank == 0 ? hist
                           : cluster.map_shared_rank(hist, 0);
  const bool churn =
      ctt::random_u32(sd, ctt::STREAM_CHURN, r, 0u, 0u) < churn_cut;
  const bool part = SWITCH && ctt::part_on(sd, r, part_cut);
  const long long row0 = static_cast<long long>(b) * N;
  const int p0 = rank * chunk, p1 = min(N, p0 + chunk);
  if (rank == 0)
    for (int s = t; s <= S; s += T) h[s] = 0;
  cluster.sync();
  for (int p = p0 + t; p < p1; p += T) {
    const bool go = p < P && !churn && n_prom[row0 + p] >= N / 2 + 1;
    const int32_t bb = best_bal[row0 + p];
    const int32_t ba = best_a[row0 + p];
    n_acc[row0 + p] = 0;
    lane[FLAG * N + p] = go;
    if (!go) continue;
    const uint32_t up = static_cast<uint32_t>(p);
    const int32_t slot = static_cast<int32_t>(
        ctt::random_u32(sd, ctt::STREAM_VALUE, r, 1u, up) %
        static_cast<uint32_t>(S));
    lane[SLOT * N + p] = slot;
    lane[VALUE * N + p] =
        bb > 0 ? acc_val[(row0 + ba) * S + slot]
               : static_cast<int32_t>(
                     ctt::random_u32(sd, ctt::STREAM_VALUE, r, 0u, up));
    atomicAdd(h + slot + 1, 1);
  }
  cluster.sync();
  // h[s + 1]: the start of bucket s; the scatter moves it to the start of
  // bucket s + 1, so that h[s] is bucket s's start and h[S] the total.
  if (rank == 0) block_exclusive_scan(h + 1, S);
  cluster.sync();
  for (int p = p0 + t; p < p1; p += T) {
    if (!lane[FLAG * N + p]) continue;  // this thread's own write
    const int k = atomicAdd(h + lane[SLOT * N + p] + 1, 1);
    const uint32_t side =
        part ? ctt::part_side(sd, r, static_cast<uint32_t>(p)) : 0u;
    lane[LIST_ID * N + k] = static_cast<int32_t>(
        static_cast<uint32_t>(p) | (side << 31));
    lane[LIST_BALLOT * N + k] = static_cast<int32_t>(
        r * static_cast<uint32_t>(N) + static_cast<uint32_t>(p) + 1u);
    lane[LIST_VALUE * N + k] = lane[VALUE * N + p];
  }
  cluster.sync();  // no block reads the first one's starts after this
  if (!in_smem || rank != 0) return;
  int32_t* o = off + static_cast<long long>(b) * (S + 1);
  for (int s = t; s <= S; s += T) o[s] = h[s];
}

// Row r of a [rows, N] bool mask pair into shared memory, a byte a
// proposer: bit 0 from m0, bit 1 from m1 (nullptr: none).
__device__ __forceinline__ void stage_row(const uint8_t* __restrict__ m0,
                                          const uint8_t* __restrict__ m1,
                                          long long row, int N, bool vec,
                                          uint8_t* out) {
  const uint8_t* a = m0 + row * N;
  const uint8_t* d = m1 != nullptr ? m1 + row * N : nullptr;
  if (vec) {
    for (int i = threadIdx.x; i < N / 16; i += blockDim.x) {
      uint4 x = __ldcs(reinterpret_cast<const uint4*>(a) + i);
      if (d != nullptr) {
        const uint4 y = __ldcs(reinterpret_cast<const uint4*>(d) + i);
        x.x |= y.x << 1;
        x.y |= y.y << 1;
        x.z |= y.z << 1;
        x.w |= y.w << 1;
      }
      reinterpret_cast<uint4*>(out)[i] = x;
    }
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      out[i] = a[i] | (d != nullptr ? d[i] << 1 : 0);
  }
}

// V consecutive int32 of a row: one 16-byte access where V = 4.
template <int V>
struct Cells {
  int32_t v[V];
};

template <int V>
__device__ __forceinline__ Cells<V> load_cells(const int32_t* p) {
  Cells<V> c;
  if (V == 4) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
    c.v[0] = x.x;
    c.v[1] = x.y;
    c.v[2] = x.z;
    c.v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) c.v[i] = __ldcs(p + i);
  }
  return c;
}

template <int V>
__device__ __forceinline__ void store_cells(int32_t* p, const Cells<V>& c) {
  if (V == 4) {
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(c.v[0], c.v[1], c.v[2], c.v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) __stcs(p + i, c.v[i]);
  }
}

// The shared memory of launches 2 and 3: [N] int32 by list position (the
// counts; the deciders), then the staged row's [N] bytes.
inline size_t row_smem(int N) {
  return static_cast<size_t>(N) * 4 +
         ((static_cast<size_t>(N) + 15) & ~static_cast<size_t>(15));
}

// Launch 2. G blocks a lane, flattened into x with the lane.
template <bool SWITCH, bool KNOBS, int V>
__global__ void __launch_bounds__(ROW_THREADS)
paxos_accept_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                    ctt::SwitchArgs sw, const uint8_t* __restrict__ deliver,
                    const uint8_t* __restrict__ prep_del,
                    const int32_t* __restrict__ props,
                    const int32_t* __restrict__ off,
                    const int32_t* __restrict__ new_promised,
                    const int32_t* __restrict__ acc_bal,
                    const int32_t* __restrict__ acc_val,
                    int32_t* __restrict__ promised2,
                    int32_t* __restrict__ acc_bal2,
                    int32_t* __restrict__ acc_val2,
                    int32_t* __restrict__ n_acc, int N, int S, int G,
                    bool in_smem, bool vec_rows,
                    const long long* __restrict__ knobs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / G;
  const int j = blockIdx.x - b * G;
  const uint32_t sd = seed[b];
  bool part = false;
  if (SWITCH) {
    if (KNOBS) {
      sw.drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
      sw.part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    }
    part = ctt::part_on(sd, r, sw.part_cut);
  }
  const int32_t* lane = props + static_cast<long long>(b) * ROWS * N;
  const int32_t* ids = lane + LIST_ID * N;
  const int32_t* ballot = lane + LIST_BALLOT * N;
  const int32_t* chosen = lane + LIST_VALUE * N;
  const int32_t* of = off + static_cast<long long>(b) * (S + 1);
  const int total = of[S];
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);
  uint8_t* rb = smem + static_cast<size_t>(N) * 4;
  const long long lane_n = static_cast<long long>(b) * N;
  if (in_smem)
    for (int k = threadIdx.x; k < total; k += blockDim.x) cnt[k] = 0;
  const int groups = S / V;
  for (int a = j; a < N; a += G) {
    const long long row = lane_n + a;
    if (in_smem) {
      __syncthreads();  // the previous row's walks are done
      stage_row(prep_del, deliver, row, N, vec_rows, rb);
      __syncthreads();
    }
    const uint8_t* pd = prep_del + row * N;
    const uint8_t* dl = deliver + row * N;
    // SWITCH: a's phase-1 uplink, its aggregator's vertex, prefix and word.
    bool up1 = false;
    uint32_t g = 0, hg = 0;
    int32_t word = 0;
    if (SWITCH) {
      up1 = sw.g.up[(static_cast<long long>(b) * sw.g.phases + 1) * N + a];
      const int ag = a / sw.g.seg;
      g = static_cast<uint32_t>(N + sw.g.K + ag);
      hg = ctt::downlink_prefix(sd, r, g);
      word = sw.g.tab[static_cast<long long>(b) * sw.g.K + ag];
    }
    const long long cell = row * S;
    // One group of V slots from its loaded cells: the walks, the counts,
    // the three outputs.
    auto accept = [&](int s0, const Cells<V>& np, Cells<V> ab, Cells<V> av) {
      Cells<V> pr;
      int k1 = __ldg(of + s0);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int k0 = k1;
        k1 = __ldg(of + s0 + i + 1);
        int32_t amax = 0;
        int best = -1;
        for (int k = k0; k < k1; ++k) {
          const int32_t bal = __ldg(ballot + k);
          if (bal < np.v[i] || bal < amax || (bal == amax && best >= 0))
            continue;
          const int p = __ldg(ids + k) & ID_MASK;
          if (in_smem ? (rb[p] & 1) : pd[p]) {
            amax = bal;
            best = k;
          }
        }
        if (best >= 0) {
          const int32_t id = __ldg(ids + best);
          const int p = id & ID_MASK;
          bool accd;
          if (!SWITCH) {
            accd = in_smem ? (rb[p] >> 1) & 1 : dl[p];
          } else {
            accd = up1 && ctt::agg_downlink(
                              sd, r, hg, g, static_cast<uint32_t>(p), word,
                              sw.drop_cut, sw.max_delay, part,
                              static_cast<uint32_t>(id) >> 31);
          }
          if (accd) {
            if (in_smem)
              ++cnt[best];  // only this thread walks bucket s0 + i
            else
              atomicAdd(n_acc + lane_n + p, 1);
          }
        }
        const bool has = amax > 0;
        pr.v[i] = has ? amax : np.v[i];
        ab.v[i] = has ? amax : ab.v[i];
        av.v[i] = has ? __ldg(chosen + best) : av.v[i];
      }
      store_cells<V>(promised2 + cell + s0, pr);
      store_cells<V>(acc_bal2 + cell + s0, ab);
      store_cells<V>(acc_val2 + cell + s0, av);
    };
    for (int q = threadIdx.x; q < groups; q += blockDim.x) {
      const int s0 = q * V;
      accept(s0, load_cells<V>(new_promised + cell + s0),
             load_cells<V>(acc_bal + cell + s0),
             load_cells<V>(acc_val + cell + s0));
    }
  }
  if (!in_smem) return;
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += blockDim.x)
    if (cnt[k] != 0)
      atomicAdd(n_acc + lane_n + (__ldg(ids + k) & ID_MASK), cnt[k]);
}

// V consecutive learned_mask bytes: one 4-byte access where V = 4.
template <int V>
__device__ __forceinline__ uint32_t load_mask(const bool* p) {
  if (V == 4) return __ldcs(reinterpret_cast<const unsigned int*>(p));
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < V; ++i)
    m |= static_cast<uint32_t>(reinterpret_cast<const uint8_t*>(p)[i])
         << (8 * i);
  return m;
}

template <int V>
__device__ __forceinline__ void store_mask(bool* p, uint32_t m) {
  if (V == 4) {
    __stcs(reinterpret_cast<unsigned int*>(p), m);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      reinterpret_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(m >> (8 * i));
  }
}

// Launch 3. The accept grid's shape, over receiver rows.
template <int V>
__global__ void __launch_bounds__(ROW_THREADS)
paxos_learn_kernel(const uint8_t* __restrict__ prep_del,
                   int32_t* __restrict__ props,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ n_acc,
                   const int32_t* __restrict__ learned_val,
                   const bool* __restrict__ learned_mask,
                   int32_t* __restrict__ learned_val2,
                   bool* __restrict__ learned_mask2, int N, int S, int G,
                   bool in_smem, bool vec_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / G;
  const int j = blockIdx.x - b * G;
  int32_t* lane = props + static_cast<long long>(b) * ROWS * N;
  const int32_t* ids = lane + LIST_ID * N;
  const int32_t* chosen = lane + LIST_VALUE * N;
  const int32_t* of = off + static_cast<long long>(b) * (S + 1);
  const int total = of[S];
  const int maj = N / 2 + 1;
  const long long lane_n = static_cast<long long>(b) * N;
  // By list position: the proposer where it decided, else -1.
  int32_t* dec = reinterpret_cast<int32_t*>(smem);
  uint8_t* rb = smem + static_cast<size_t>(N) * 4;
  if (in_smem) {
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int p = __ldg(ids + k) & ID_MASK;
      dec[k] = n_acc[lane_n + p] >= maj ? p : -1;
    }
  }
  if (j == 0) {
    int32_t* flag = lane + FLAG * N;
    for (int p = threadIdx.x; p < N; p += blockDim.x)
      flag[p] = flag[p] && n_acc[lane_n + p] >= maj;
  }
  const int groups = S / V;
  for (int n = j; n < N; n += G) {
    const long long row = lane_n + n;
    if (in_smem) {
      __syncthreads();
      stage_row(prep_del, nullptr, row, N, vec_rows, rb);
      __syncthreads();
    }
    const uint8_t* pd = prep_del + row * N;
    const long long cell = row * S;
    // One group of V slots from its loaded cells: the walks, the outputs.
    auto learn = [&](int s0, Cells<V> lv, uint32_t known) {
      uint32_t found = 0;
      int k1 = __ldg(of + s0);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int k0 = k1;
        k1 = __ldg(of + s0 + i + 1);
        int low = N, at = -1;
        for (int k = k0; k < k1; ++k) {
          int p;
          if (in_smem) {
            p = dec[k];
          } else {
            p = __ldg(ids + k) & ID_MASK;
            if (n_acc[lane_n + p] < maj) p = -1;
          }
          if (p < 0 || p >= low) continue;
          if (p == n || (in_smem ? rb[p] : pd[p])) {
            low = p;
            at = k;
          }
        }
        if (at >= 0) {
          found |= 1u << (8 * i);
          if (!((known >> (8 * i)) & 0xFFu)) lv.v[i] = __ldg(chosen + at);
        }
      }
      store_cells<V>(learned_val2 + cell + s0, lv);
      store_mask<V>(learned_mask2 + cell + s0, known | found);
    };
    for (int q = threadIdx.x; q < groups; q += blockDim.x) {
      const int s0 = q * V;
      learn(s0, load_cells<V>(learned_val + cell + s0),
            load_mask<V>(learned_mask + cell + s0));
    }
  }
}

// The launch shape of launches 2 and 3: threads a block (the slot groups
// of a row, rounded to warps, at most ROW_THREADS) and blocks a lane
// (enough resident blocks to fill the card, at most a row each).
struct RowGrid {
  int threads, G;
};

template <typename Kernel>
int row_grid(Kernel kernel, int B, int N, int groups, size_t smem,
             RowGrid* out) {
  int threads = ((groups + 31) / 32) * 32;
  threads = threads < 32 ? 32 : threads > ROW_THREADS ? ROW_THREADS : threads;
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem));
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(sms) * per_sm;
  long long G = (resident + B - 1) / B;
  G = G < 1 ? 1 : G > N ? N : G;
  if (G * B > 0x7FFFFFFFLL) G = 0x7FFFFFFFLL / B;
  out->threads = threads;
  out->G = static_cast<int>(G);
  return 0;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool aligned(const void* p, size_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

template <int V>
int launch_rows(const uint32_t* seed, uint32_t r, const ctt::SwitchArgs& sw,
                const uint8_t* deliver, const uint8_t* prep_del,
                const int32_t* new_promised, const int32_t* acc_bal,
                const int32_t* acc_val, const int32_t* learned_val,
                const bool* learned_mask, int32_t* promised2,
                int32_t* acc_bal2, int32_t* acc_val2, int32_t* learned_val2,
                bool* learned_mask2, int32_t* props, int32_t* n_acc,
                int32_t* off, int B, int N, int S, bool switched,
                const long long* knobs, cudaStream_t st) {
  const size_t smem = row_smem(N);
  const bool in_smem = smem <= static_cast<size_t>(ctt::ROW_SMEM_MAX);
  const size_t dyn = in_smem ? smem : 0;
  const bool vec_rows = N % 16 == 0 && aligned(deliver, 16) &&
                        aligned(prep_del, 16);
  const auto accept = !switched        ? paxos_accept_kernel<false, false, V>
                      : knobs != nullptr ? paxos_accept_kernel<true, true, V>
                                         : paxos_accept_kernel<true, false, V>;
  const auto learn = paxos_learn_kernel<V>;
  int err = allow_smem(accept, dyn);
  if (err == 0) err = allow_smem(learn, dyn);
  RowGrid ga, gl;
  if (err == 0) err = row_grid(accept, B, N, S / V, dyn, &ga);
  if (err == 0) err = row_grid(learn, B, N, S / V, dyn, &gl);
  if (err != 0) return err;
  accept<<<static_cast<unsigned>(static_cast<long long>(ga.G) * B),
           ga.threads, dyn, st>>>(
      seed, r, sw, deliver, prep_del, props, off, new_promised, acc_bal,
      acc_val, promised2, acc_bal2, acc_val2, n_acc, N, S, ga.G, in_smem,
      vec_rows, knobs);
  learn<<<static_cast<unsigned>(static_cast<long long>(gl.G) * B),
          gl.threads, dyn, st>>>(prep_del, props, off, n_acc, learned_val,
                                 learned_mask, learned_val2, learned_mask2,
                                 N, S, gl.G, in_smem, vec_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// props is [B, 6, N] int32 scratch (row 2, PROP_FLAG, holds the decided
// flags after the call), n_acc [B, N] int32 and off [B, S + 1] int32
// scratch, all set here. knobs is a knob batch's [B, 12] table (knobs.cuh;
// null but in a knob batch): churn_cut, drop_cut and part_cut are then the
// base's and each lane reads its own.
extern "C" int ctt_paxos_accept_learn(
    const uint32_t* seed, uint32_t r, const uint8_t* deliver,
    const uint8_t* prep_del, const int32_t* new_promised,
    const int32_t* n_prom, const int32_t* best_bal, const int32_t* best_a,
    const int32_t* acc_bal, const int32_t* acc_val,
    const int32_t* learned_val, const bool* learned_mask, int32_t* promised2,
    int32_t* acc_bal2, int32_t* acc_val2, int32_t* learned_val2,
    bool* learned_mask2, int32_t* props, int32_t* n_acc, int32_t* off,
    int P, uint32_t churn_cut, int B, int N, int S, const unsigned char* up,
    const int32_t* tab, int K, uint32_t drop_cut, uint32_t part_cut,
    uint32_t max_delay, const long long* knobs, cudaStream_t st) {
  if ((up == nullptr) != (tab == nullptr) ||
      (up != nullptr && (K < 1 || K > N)) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const bool switched = up != nullptr;
  // Launch 1.
  const long long hist_bytes = (static_cast<long long>(S) + 1) * 4;
  const bool hist_smem = hist_bytes <= ctt::ROW_SMEM_MAX;
  const auto gate = switched ? (knobs != nullptr ? paxos_gate_kernel<true, true>
                                                 : paxos_gate_kernel<true, false>)
                             : (knobs != nullptr ? paxos_gate_kernel<false, true>
                                                 : paxos_gate_kernel<false, false>);
  const size_t gate_dyn = hist_smem ? static_cast<size_t>(hist_bytes) : 0;
  int err = allow_smem(gate, gate_dyn);
  if (err != 0) return err;
  int cs = (N + GATE_THREADS - 1) / GATE_THREADS;
  cs = cs > GATE_CLUSTER ? GATE_CLUSTER : cs;
  const int chunk = (N + cs - 1) / cs;
  const long long wide = chunk > S + 1 ? chunk : S + 1;
  const int gate_threads =
      wide >= GATE_THREADS ? GATE_THREADS
                           : static_cast<int>((wide + 31) / 32 * 32);
  if (static_cast<long long>(B) * cs > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cs));
  cfg.blockDim = dim3(static_cast<unsigned>(gate_threads));
  cfg.dynamicSmemBytes = gate_dyn;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cs);
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, gate, seed, r, n_prom, best_bal, best_a, acc_val, props, off,
      n_acc, P, churn_cut, part_cut, N, S, chunk, hist_smem, knobs));
  if (err == 0) err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // Launches 2 and 3: 16-byte accesses of the [N, S] tensors where every
  // row starts on 16 bytes (4 on the masks).
  const ctt::SwitchArgs sw =
      ctt::switch_args(up, tab, K, 2, N, drop_cut, part_cut, max_delay);
  const bool vec = S % 4 == 0 && aligned(new_promised, 16) &&
                   aligned(acc_bal, 16) && aligned(acc_val, 16) &&
                   aligned(learned_val, 16) && aligned(promised2, 16) &&
                   aligned(acc_bal2, 16) && aligned(acc_val2, 16) &&
                   aligned(learned_val2, 16) && aligned(learned_mask, 4) &&
                   aligned(learned_mask2, 4);
  return vec ? launch_rows<4>(seed, r, sw, deliver, prep_del, new_promised,
                              acc_bal, acc_val, learned_val, learned_mask,
                              promised2, acc_bal2, acc_val2, learned_val2,
                              learned_mask2, props, n_acc, off, B, N, S,
                              switched, knobs, st)
             : launch_rows<1>(seed, r, sw, deliver, prep_del, new_promised,
                              acc_bal, acc_val, learned_val, learned_mask,
                              promised2, acc_bal2, acc_val2, learned_val2,
                              learned_mask2, props, n_acc, off, B, N, S,
                              switched, knobs, st);
}
