// Kernel KV: SPEC §6b P6 decide gossip and P7 timers of the broadcast PBFT
// round at every node of each lane.
//
// Replaces: consensus_tpu/engines/pbft_bcast.py pbft_bcast_round (K15)
// lines 630-675 on its flat path, and the same phases of
// consensus_tpu/engines/pbft_sweep.py pbft_bcast_round_padded (K17) lines
// 460-485: per (lane, slot, side) the decider is the least-id sender of
// that side (bit 0 and bit 1 of the node byte KT wrote) that has
// committed the slot as P5 left it; a node that has not committed the
// slot adopts its side's decider's decided value (padded nodes too, as in
// the JAX package: nothing reads their rows); then a node that committed
// a slot this round, against the round's entry, sets its timer to 0,
// another whose P0-P2 reset it keeps it, and the rest count it up.
//
// Bound: bytes. Each (node, slot) reads committed, dval and the entry's
// committed and writes committed and dval (11 bytes); each node reads its
// byte, timer and reset flag and writes its timer (10 bytes). The
// deciders' search reads committed down to the first decider of each
// (slot, side) at most, already counted. At pbft-100k-bcast (B = 8, N =
// 100 000, S = 16) that is about 149 MB a round, 44 us at 3.35 TB/s.
// Design: two launches, no memset and no atomics on device memory. Lanes
// and node tiles share the grid's x (lane x / tiles), so the lane count
// has no grid limit of its own.
//  1. A block per TILE nodes of a lane writes the tile's least decider of
//     each (side, slot), or NONE, with plain stores. Each thread reads the
//     bytes of 16 consecutive nodes at once (one 16-byte load), then the
//     committed rows of its eligible nodes in id order, four at a time,
//     only while its own nodes have not yet shown every slot of that side
//     (four at a time measured faster than two, eight or sixteen); a
//     warp's first holders of each newly seen slot come from one ballot a
//     slot, and the block's warps meet in shared memory.
//  2. A thread a node: its block first takes the lane's minima over the
//     tiles (the lane's [tiles, 2, S] table, one coalesced pass) and the
//     deciders' values (dval[imin, s], at most 2 S a lane) into shared
//     memory; each node then moves its rows with 16-byte loads and stores
//     (where S is a multiple of 16; byte by byte otherwise), adopts, and
//     runs P7 on its own slots. Outputs are fresh tensors, so no adoption
//     is read the same round.
// Its CRASH instance (SPEC §6c, picked by the launch's `crash` argument)
// keeps a node of bit 2 (down at the round's end) from adopting
// (pbft_bcast.py:663-664); such a node is no decider either, since KT
// cleared its bit 0.
// Its BYZ instance (SPEC §3c, picked when n_real is given, with byzantine
// nodes in either mode) takes the honest senders only as deciders (node i
// of a lane is honest when i < n_real - nb; pbft_bcast.py:650,
// pbft_sweep.py:461): bit 0 says that a node's broadcast goes out, honest
// or not.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MIN_THREADS = 256;
constexpr int WARPS = MIN_THREADS / 32;
constexpr int PER_THREAD = 16;                 // launch 1's nodes a thread
constexpr int TILE = MIN_THREADS * PER_THREAD;  // launch 1's nodes a block
constexpr int BATCH = 4;                        // rows read at a time
constexpr int CHUNK = 32;                       // slots a pass of launch 1
constexpr int ADOPT_THREADS = 512;
constexpr int NONE = 0x7FFFFFFF;
// Launch 2's shared table of lane minima and values: 2 S pairs of int32
// each, where it fits; beyond it the minima are read from the tiles' table.
constexpr int SMEM_MAX = 96 * 1024;

// Bytes of bool (0 or 1) to bits: four bytes of w to bits 0-3.
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xFu;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | (pack4(v.y) << 4) | (pack4(v.z) << 8) |
         (pack4(v.w) << 12);
}

// Slots [c0, c0 + W) of node row `row` of committed as bits.
template <bool VEC>
__device__ __forceinline__ uint32_t row_bits(const bool* __restrict__ com,
                                             long long row, int S, int c0,
                                             int W) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(com) + row * S + c0;
  if (VEC) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    uint32_t m = pack16(__ldg(v));
    if (W > 16) m |= pack16(__ldg(v + 1)) << 16;
    return m;
  }
  uint32_t m = 0;
  for (int q = 0; q < W; ++q) m |= static_cast<uint32_t>(p[q] != 0) << q;
  return m;
}

// Launch 1. Grid B * tiles, tiles = ceil(N / TILE). Writes imin[b, tile,
// side, s]: the least decider of the tile, or NONE.
template <bool BYZ, bool VEC>
__global__ void __launch_bounds__(MIN_THREADS)
decide_min_kernel(const uint8_t* __restrict__ bits,
                  const bool* __restrict__ committed,
                  int* __restrict__ imin, int N, int S, int tiles,
                  const int32_t* __restrict__ n_real, int nb) {
  __shared__ int low[WARPS][2][CHUNK];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const long long nodes = static_cast<long long>(b) * N;
  const int first = tile * TILE + t * PER_THREAD;  // this thread's nodes
  // BYZ: the senders from the first byzantine id up decide nothing.
  const int top = BYZ ? min(N, n_real[b] - nb) : N;
  uint32_t elig = 0, side = 0;  // bit u: node first + u
  if (VEC && first + PER_THREAD <= N) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(bits + nodes +
                                                         first));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const uint32_t by = (w[u >> 2] >> (8 * (u & 3))) & 0xFFu;
      elig |= static_cast<uint32_t>((by & 1u) && first + u < top) << u;
      side |= ((by >> 1) & 1u) << u;
    }
  } else {
    for (int u = 0; u < PER_THREAD && first + u < N; ++u) {
      const uint32_t by = bits[nodes + first + u];
      elig |= static_cast<uint32_t>((by & 1u) && first + u < top) << u;
      side |= ((by >> 1) & 1u) << u;
    }
  }
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int W = min(CHUNK, S - c0);
    const uint32_t full = W == 32 ? FULL : (1u << W) - 1u;
    for (int k = lane; k < 2 * CHUNK; k += 32) (&low[warp][0][0])[k] = NONE;
    __syncwarp();
    uint32_t have0 = 0u, have1 = 0u;  // slots its nodes showed, by side
    for (int u0 = 0; u0 < PER_THREAD; u0 += BATCH) {
      // The batch's rows, read together, where the thread still needs them.
      uint32_t m[BATCH];
#pragma unroll
      for (int v = 0; v < BATCH; ++v) {
        const int u = u0 + v;
        const int sd = (side >> u) & 1;
        m[v] = ((elig >> u) & 1) && (sd ? have1 : have0) != full
                   ? row_bits<VEC>(committed, nodes + first + u, S, c0, W)
                   : 0u;
      }
#pragma unroll
      for (int v = 0; v < BATCH; ++v) {
        const int u = u0 + v;
        const int sd = (side >> u) & 1;
        const uint32_t fresh = m[v] & ~(sd ? have1 : have0);
        if (sd)
          have1 |= fresh;
        else
          have0 |= fresh;
        // The warp's lowest lane that first shows slot q of side x at u
        // holds the warp's least decider among its nodes u.
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint32_t mine = sd == x ? fresh : 0u;
          uint32_t any = __reduce_or_sync(FULL, mine);
          while (any != 0u) {
            const int q = __ffs(any) - 1;
            any &= any - 1u;
            const uint32_t who = __ballot_sync(FULL, (mine >> q) & 1u);
            const int id = tile * TILE + (warp * 32 + __ffs(who) - 1) *
                                             PER_THREAD + u;
            if (lane == 0 && id < low[warp][x][q]) low[warp][x][q] = id;
          }
        }
      }
    }
    __syncthreads();
    for (int k = t; k < 2 * W; k += MIN_THREADS) {
      const int x = k / W, q = k - x * W;
      int v = NONE;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v = min(v, low[w][x][q]);
      imin[((static_cast<long long>(b) * tiles + tile) * 2 + x) * S + c0 + q] =
          v;
    }
    __syncthreads();
  }
}

// The lane's least decider of pair q = side * S + s over its tiles.
__device__ __forceinline__ int lane_low(const int* __restrict__ imin,
                                        long long b, int tiles, int S,
                                        int q) {
  int v = NONE;
  for (int t = 0; t < tiles; ++t)
    v = min(v, __ldg(imin + (b * tiles + t) * 2 * S + q));
  return v;
}

// Sixteen slots of a node: committed, the entry's committed and dval.
struct Row16 {
  uint4 c, s;
  int4 d[4];
};

__device__ __forceinline__ Row16 load16(const bool* committed,
                                        const bool* committed_start,
                                        const int32_t* dval, long long cell,
                                        int c) {
  Row16 r;
  r.c = __ldcs(reinterpret_cast<const uint4*>(committed + cell) + c);
  r.s = __ldcs(reinterpret_cast<const uint4*>(committed_start + cell) + c);
  const int4* dp = reinterpret_cast<const int4*>(dval + cell) + 4 * c;
#pragma unroll
  for (int w = 0; w < 4; ++w) r.d[w] = __ldcs(dp + w);
  return r;
}

// Launch 2. Grid B * blocks, blocks = ceil(N / ADOPT_THREADS): a thread a
// node. In shared memory (in_smem): low[2 S], then val[2 S]. A node's byte,
// timer and reset flag are loaded before the block takes the lane's minima.
template <bool CRASH, bool VEC>
__global__ void __launch_bounds__(ADOPT_THREADS)
decide_adopt_kernel(const uint8_t* __restrict__ bits,
                    const bool* __restrict__ committed,
                    const int32_t* __restrict__ dval,
                    const bool* __restrict__ committed_start,
                    const int32_t* __restrict__ timer,
                    const bool* __restrict__ reset,
                    const int* __restrict__ imin,
                    bool* __restrict__ com_out,
                    int32_t* __restrict__ dval_out,
                    int32_t* __restrict__ timer_out, int N, int S, int tiles,
                    int blocks, bool in_smem) {
  extern __shared__ int table[];
  const int b = blockIdx.x / blocks;
  const int i = (blockIdx.x - b * blocks) * blockDim.x + threadIdx.x;
  const long long nodes = static_cast<long long>(b) * N;
  const bool live = i < N;
  const long long row = nodes + (live ? i : 0);
  const long long cell = row * S;
  uint8_t by = 0;
  int32_t tm = 0;
  bool rs = false;
  if (live) {
    by = bits[row];
    tm = timer[row];
    rs = reset[row];
  }
  int* low = table;
  int* val = table + 2 * S;
  if (in_smem) {
    for (int q = threadIdx.x; q < 2 * S; q += blockDim.x) low[q] = NONE;
    __syncthreads();
    const int* lane_tab = imin + static_cast<long long>(b) * tiles * 2 * S;
    for (int k = threadIdx.x; k < tiles * 2 * S; k += blockDim.x) {
      const int v = __ldg(lane_tab + k);
      if (v != NONE) atomicMin(low + k % (2 * S), v);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < 2 * S; q += blockDim.x) {
      const int lo = low[q];
      val[q] = lo < N ? __ldg(dval + (nodes + lo) * S + q % S) : 0;
    }
    __syncthreads();
  }
  if (!live) return;
  const int base = ((by >> 1) & 1) * S;  // the node's side's pairs
  const bool takes = !(CRASH && (by & 4));
  bool changed = false;
  if (VEC) {
    for (int c = 0; c < S / 16; ++c) {
      Row16 r = load16(committed, committed_start, dval, cell, c);
      uint32_t cw[4] = {r.c.x, r.c.y, r.c.z, r.c.w};
      const uint32_t sw[4] = {r.s.x, r.s.y, r.s.z, r.s.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        int* dw = reinterpret_cast<int*>(&r.d[w]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t sh = 8 * k;
          if (takes && !((cw[w] >> sh) & 1u)) {
            const int q = base + 16 * c + 4 * w + k;
            const int lo = in_smem ? low[q] : lane_low(imin, b, tiles, S, q);
            if (lo < N) {
              cw[w] |= 1u << sh;
              dw[k] = in_smem ? val[q]
                              : __ldg(dval + (nodes + lo) * S + q - base);
            }
          }
        }
        changed |= (cw[w] & ~sw[w]) != 0u;
      }
      __stcs(reinterpret_cast<uint4*>(com_out + cell) + c,
             make_uint4(cw[0], cw[1], cw[2], cw[3]));
      int4* op = reinterpret_cast<int4*>(dval_out + cell) + 4 * c;
#pragma unroll
      for (int w = 0; w < 4; ++w) __stcs(op + w, r.d[w]);
    }
  } else {
    const uint8_t* cp = reinterpret_cast<const uint8_t*>(committed) + cell;
    const uint8_t* sp = reinterpret_cast<const uint8_t*>(committed_start) +
                        cell;
    for (int s = 0; s < S; ++s) {
      bool cc = cp[s] != 0;
      int32_t d = dval[cell + s];
      if (takes && !cc) {
        const int q = base + s;
        const int lo = in_smem ? low[q] : lane_low(imin, b, tiles, S, q);
        if (lo < N) {
          cc = true;
          d = in_smem ? val[q] : dval[(nodes + lo) * S + s];
        }
      }
      com_out[cell + s] = cc;
      dval_out[cell + s] = d;
      changed |= cc && !sp[s];
    }
  }
  timer_out[row] =
      changed ? 0
      : rs    ? tm
              : static_cast<int32_t>(static_cast<uint32_t>(tm) + 1u);
}

bool aligned(const void* p, size_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// imin is scratch, [B, ceil(N / 4096), 2, S] int32, set here. n_real is
// null on the flat path; with byzantine nodes it is [B] int32 and nb their
// count.
extern "C" int ctt_bcast_decide(const uint8_t* bits, const bool* committed,
                                const int32_t* dval,
                                const bool* committed_start,
                                const int32_t* timer, const bool* reset,
                                bool* com_out, int32_t* dval_out,
                                int32_t* timer_out, int* imin, int B, int N,
                                int S, int crash, const int32_t* n_real,
                                int nb, cudaStream_t st) {
  if (nb < 0 || nb > N) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + TILE - 1) / TILE;
  const long long blocks = (N + ADOPT_THREADS - 1) / ADOPT_THREADS;
  if (static_cast<long long>(tiles) * B > 0x7FFFFFFFLL ||
      blocks * B > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  // 16-byte rows where every row starts on 16 bytes.
  const bool vec = S % 16 == 0 && aligned(committed, 16) &&
                   aligned(committed_start, 16) && aligned(dval, 16) &&
                   aligned(com_out, 16) && aligned(dval_out, 16);
  if (S > 0) {
    const bool vec_bits = N % 16 == 0 && aligned(bits, 16);
    const auto minima =
        n_real != nullptr
            ? (vec ? (vec_bits ? decide_min_kernel<true, true>
                               : decide_min_kernel<true, false>)
                   : decide_min_kernel<true, false>)
            : (vec ? (vec_bits ? decide_min_kernel<false, true>
                               : decide_min_kernel<false, false>)
                   : decide_min_kernel<false, false>);
    minima<<<static_cast<unsigned>(tiles * B), MIN_THREADS, 0, st>>>(
        bits, committed, imin, N, S, tiles, n_real, nb);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  const long long table = 16LL * S;
  const bool in_smem = table <= SMEM_MAX;
  const size_t dyn = in_smem ? static_cast<size_t>(table) : 0;
  const auto adopt = crash ? (vec ? decide_adopt_kernel<true, true>
                                  : decide_adopt_kernel<true, false>)
                           : (vec ? decide_adopt_kernel<false, true>
                                  : decide_adopt_kernel<false, false>);
  err = static_cast<int>(cudaFuncSetAttribute(
      adopt, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn)));
  if (err != 0) return err;
  adopt<<<static_cast<unsigned>(blocks * B), ADOPT_THREADS, dyn, st>>>(
      bits, committed, dval, committed_start, timer, reset, imin, com_out,
      dval_out, timer_out, N, S, tiles, static_cast<int>(blocks), in_smem);
  return static_cast<int>(cudaGetLastError());
}
