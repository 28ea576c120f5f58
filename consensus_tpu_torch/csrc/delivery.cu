// Kernel KL: the SPEC §2 delivery mask of one round over all N nodes of each
// sweep, [B, N, N] bool, for the dense Raft engine.
//
// Replaces: consensus_tpu/ops/adversary.py delivery (lines 61-86), with the
// delivery mixer of core/rng.py delivery_u32_jnp (K2) and the SPEC §A.2 term
// delayed_open (K13, ctt::delayed_open in rng.cuh) inside it, as
// engines/raft.py raft_round, engines/pbft.py, engines/paxos.py and the
// dense f-ladder call it once a round.
//
// Edge i -> j of round r is delivered when i != j, the mixer draw
// fmix(absorb(absorb(absorb(seed ^ DELIVER, r), i), j)) is not below
// drop_cut or (max_delay > 0) a flight dropped on the edge in one of the
// last max_delay rounds arrives now (evaluated only where the round's own
// draw dropped), and, in a round whose partition is active (a Threefry draw
// below part_cut), both ends drew the same side.
//
// Bound: operations. The output is B * N * N bytes (8.4 MB at raft-1kx1k,
// B = 8, N = 1024: 2.5 us at 3.35 TB/s); each edge takes one mixer absorb
// and the finaliser, about 23 integer operations once the (seed, r) and
// per-row absorbs are hoisted (5.8 us at 33.5e12 operations a second).
// Design: with a partition (part_cut != 0), launch 1 draws each node's
// side once, a thread per node, writing 0 for every node of a sweep whose
// partition is not active this round, so that launch 2 reads one byte per
// end instead of three Threefry draws an edge. Launch 2: a block per
// (sweep, sender row) and column chunk; each thread hoists the row's
// absorbs and writes four consecutive edges, as one 32-bit store when rows
// are 4-byte aligned (N % 4 == 0). Its DELAY instance, which the launch
// picks when max_delay > 0, adds the delay term; the other is launch 2 as
// it was before the delay existed. A small N (raft-5node: N = 5) gets
// blocks of one warp. Its CRASH instances, which the launch picks when the
// round's SPEC §6c flag word of kernel KAH is given, cut every edge with an
// end down at the round's end (the dense engines' deliver & up[:, None] &
// up[None, :]); a down sender's row is all zeros. Its STICKY instances
// (SPEC §A.3 "sticky", picked when the round's input roles are given)
// clear column tgt, every edge into the target, in a lane whose round
// activation fires (ctt::attack_fires) while the target led at the round's
// start (raft.py:241-253): only the thread that writes column tgt of a row
// reads the target's role and draws.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's partition cutoff (launch 1) and its drop
// cutoff, and in a STICKY instance its attack cutoff and target (launch 2),
// from the lane's row of the table in place of the arguments. The base's
// partition cutoff still decides whether launch 1 runs, so a lane whose
// partition cutoff is 0 under a base with partitions draws sides that
// never count. A lane's target is the int32 of its u32 column, as the JAX
// package's traced index (consensus_tpu/network/runner.py:1029-1031): the
// role is read at the index as its gather reads it (a negative one counts
// from the end, then clamped to [0, N - 1]), while the jam compares column
// ids with the target as it is, so an out-of-range target jams nothing.
#include <cuda_runtime.h>

#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int VEC = 4;
constexpr int32_t ROLE_L = 2;

// Launch 1. A thread per (sweep, node).
template <bool KNOBS>
__global__ void delivery_side_kernel(const uint32_t* __restrict__ seed,
                                     uint32_t r, uint32_t part_cut,
                                     uint8_t* __restrict__ side,
                                     int N, long long rows,
                                     const long long* __restrict__ knobs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int b = static_cast<int>(row / N);
  if (KNOBS) part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
  const uint32_t node =
      static_cast<uint32_t>(row - static_cast<long long>(b) * N);
  const uint32_t sd = seed[b];
  const bool active =
      ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 0u, 0u) < part_cut;
  side[row] = active
      ? static_cast<uint8_t>(
            ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 1u, node) & 1u)
      : 0;
}

// Launch 2. Grid (B * N rows, ceil(N / (VEC * blockDim.x))).
template <bool DELAY, bool CRASH, bool STICKY, bool KNOBS>
__global__ void delivery_kernel(const uint32_t* __restrict__ seed,
                                uint32_t r, const uint8_t* __restrict__ side,
                                unsigned char* __restrict__ out, int N,
                                uint32_t drop_cut, uint32_t max_delay,
                                const unsigned char* __restrict__ flags,
                                const int32_t* __restrict__ role, int tgt,
                                uint32_t attack_cut,
                                const long long* __restrict__ knobs) {
  const long long row = blockIdx.x;  // b * N + i
  const int b = static_cast<int>(row / N);
  const int i = static_cast<int>(row - static_cast<long long>(b) * N);
  const int j0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (j0 >= N) return;
  // The node whose role the sticky attack reads (tgt itself on the flat
  // path, where it is in range).
  int tread = tgt;
  if (KNOBS) {
    drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    if (STICKY) {
      attack_cut = ctt::knob(knobs, b, ctt::KNOB_ATTACK);
      tgt = static_cast<int32_t>(ctt::knob(knobs, b, ctt::KNOB_ATTACK_TARGET));
      tread = tgt < 0 ? tgt + N : tgt;
      tread = tread < 0 ? 0 : (tread >= N ? N - 1 : tread);
    }
  }
  const uint32_t sd = seed[b];
  const uint32_t h = ctt::mix_absorb(
      ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), static_cast<uint32_t>(i));
  const uint8_t side_i = side ? side[row] : 0;
  const uint8_t* side_b = side ? side + static_cast<long long>(b) * N : side;
  const bool row_up = !CRASH || !ctt::crash_down(flags, b, N, i);
  uint32_t word = 0u;
  for (int v = 0; v < VEC; ++v) {
    const int j = j0 + v;
    if (j >= N) break;
    const bool ok = j != i && row_up &&
        (!CRASH || !ctt::crash_down(flags, b, N, j)) &&
        (ctt::mix_fin(ctt::mix_absorb(h, static_cast<uint32_t>(j))) >=
             drop_cut ||
         (DELAY && ctt::delayed_open(sd, r, static_cast<uint32_t>(i),
                                     static_cast<uint32_t>(j), drop_cut,
                                     max_delay))) &&
        (!side || side_b[j] == side_i);
    word |= static_cast<uint32_t>(ok) << (8 * v);
  }
  if (STICKY && tgt >= j0 && tgt < j0 + VEC &&
      role[static_cast<long long>(b) * N + tread] == ROLE_L &&
      ctt::attack_fires(sd, r, attack_cut))
    word &= ~(0xFFu << (8 * (tgt - j0)));
  unsigned char* o = out + row * N + j0;
  if ((N & (VEC - 1)) == 0) {
    *reinterpret_cast<uint32_t*>(o) = word;
  } else {
    for (int v = 0; v < VEC && j0 + v < N; ++v)
      o[v] = static_cast<unsigned char>((word >> (8 * v)) & 0xFFu);
  }
}

using DeliveryKernel = decltype(&delivery_kernel<false, false, false, false>);

template <bool KNOBS>
DeliveryKernel delivery_instance(bool delay, bool crash, bool sticky) {
  if (crash)
    return delay ? (sticky ? delivery_kernel<true, true, true, KNOBS>
                           : delivery_kernel<true, true, false, KNOBS>)
                 : (sticky ? delivery_kernel<false, true, true, KNOBS>
                           : delivery_kernel<false, true, false, KNOBS>);
  return delay ? (sticky ? delivery_kernel<true, false, true, KNOBS>
                         : delivery_kernel<true, false, false, KNOBS>)
               : (sticky ? delivery_kernel<false, false, true, KNOBS>
                         : delivery_kernel<false, false, false, KNOBS>);
}

}  // namespace

// knobs is a knob batch's [B, 12] table (knobs.cuh; null but in a knob
// batch): the cutoff and target arguments are then the base's, which pick
// the launches, and each lane reads its own from its row.
extern "C" int ctt_delivery(const uint32_t* seed, uint32_t r,
                            unsigned char* out, uint8_t* side, int B, int N,
                            uint32_t drop_cut, uint32_t part_cut,
                            uint32_t max_delay, const unsigned char* flags,
                            const int32_t* role, int tgt,
                            uint32_t attack_cut, const long long* knobs,
                            cudaStream_t st) {
  const bool kn = knobs != nullptr;
  if (role != nullptr && !kn && (tgt < 0 || tgt >= N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long rows = static_cast<long long>(B) * N;
  if (part_cut != 0u) {
    const auto sides =
        kn ? delivery_side_kernel<true> : delivery_side_kernel<false>;
    sides<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
        seed, r, part_cut, side, N, rows, knobs);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  } else {
    side = nullptr;
  }
  const int quads = (N + VEC - 1) / VEC;
  const int threads = quads >= 256 ? 256 : ((quads + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((quads + threads - 1) / threads));
  const bool delay = max_delay != 0u, sticky = role != nullptr;
  const bool crash = flags != nullptr;
  const auto kernel = kn ? delivery_instance<true>(delay, crash, sticky)
                         : delivery_instance<false>(delay, crash, sticky);
  kernel<<<grid, threads, 0, st>>>(seed, r, side, out, N, drop_cut,
                                   max_delay, flags, role, tgt, attack_cut,
                                   knobs);
  return static_cast<int>(cudaGetLastError());
}
