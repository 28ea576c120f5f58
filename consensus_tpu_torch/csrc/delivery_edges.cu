// Kernel KB: the SPEC §2 delivery mask between A sender (or receiver) ids and
// all N node ids of each sweep, in one pass.
//
// Replaces: consensus_tpu/ops/adversary.py delivery_edges, with the delivery
// mixer of core/rng.py delivery_u32_jnp and the SPEC §A.2 term delayed_open
// (K13, ctt::delayed_open in rng.cuh) inside it, as engines/raft_sparse.py
// calls it four times a round: requests [A, N], responses [N, A], heartbeats
// [A, N] and acks [N, A].
//
// An edge (s, d) of round r is delivered when both ids are >= 0, s != d, the
// mixer draw fmix(absorb(absorb(absorb(seed ^ DELIVER, r), s), d)) is not
// below drop_cut or (max_delay > 0) a flight dropped on the edge in one of
// the last max_delay rounds arrives now, and, in a round whose partition is
// active (a Threefry draw below part_cut), both ends drew the same side. The
// delay term is evaluated only where the round's own draw dropped, in the
// kernels' DELAY instances, which the launch picks when max_delay > 0.
// Under SPEC §6c (the CRASH instances, picked when the round's flag word of
// kernel KAH is given) an edge with an end down at the round's end is not
// delivered (consensus_tpu/engines/raft_sparse.py:192-195).
//
// Bound: the [B, A, N] bool output (6.4 MB at the flagship shape) against
// ~20 integer operations an edge once the (seed, r) and per-row absorbs are
// hoisted; both are a few microseconds at 3.35 TB/s and the card's integer
// rate. Design: one thread per node id j, a 2-D grid over (j, sweep row);
// each thread hoists the absorbs it shares across its edges and writes its
// bytes so that a warp covers one contiguous span. The partition draws are
// skipped entirely when part_cut is 0, as on the flagship path.
#include <cuda_runtime.h>

#include "crash.cuh"
#include "rng.cuh"

namespace {

__device__ __forceinline__ bool same_side(uint32_t seed, uint32_t r,
                                          uint32_t part_cut, uint32_t s,
                                          uint32_t d) {
  if (part_cut == 0u) return true;
  if (ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 0u, 0u) >= part_cut)
    return true;
  const uint32_t side_s =
      ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 1u, s) & 1u;
  const uint32_t side_d =
      ctt::random_u32(seed, ctt::STREAM_PARTITION, r, 1u, d) & 1u;
  return side_s == side_d;
}

// out[b, a, j]: ids[b, a] sends to node j. Grid (ceil(N / 256), B * A).
template <bool DELAY, bool CRASH>
__global__ void edges_src_kernel(const uint32_t* __restrict__ seed,
                                 uint32_t r, const int32_t* __restrict__ ids,
                                 unsigned char* __restrict__ out, int A,
                                 int N, uint32_t drop_cut,
                                 uint32_t part_cut, uint32_t max_delay,
                                 const unsigned char* __restrict__ flags) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int row = blockIdx.y;  // b * A + a
  const int b = row / A;
  const int32_t id = ids[row];
  const uint32_t sd = seed[b];
  const uint32_t s = static_cast<uint32_t>(id);
  const uint32_t d = static_cast<uint32_t>(j);
  bool ok = id >= 0 && s != d;
  if (CRASH && ok)
    ok = !ctt::crash_down(flags, b, N, id) && !ctt::crash_down(flags, b, N, j);
  if (ok) {
    const uint32_t h = ctt::mix_absorb(
        ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), s);
    ok = (ctt::mix_fin(ctt::mix_absorb(h, d)) >= drop_cut ||
          (DELAY && ctt::delayed_open(sd, r, s, d, drop_cut, max_delay))) &&
         same_side(sd, r, part_cut, s, d);
  }
  out[static_cast<long long>(row) * N + j] = ok;
}

// out[b, j, a]: node j sends to ids[b, a]. Grid (ceil(N / 256), B).
template <bool DELAY, bool CRASH>
__global__ void edges_dst_kernel(const uint32_t* __restrict__ seed,
                                 uint32_t r, const int32_t* __restrict__ ids,
                                 unsigned char* __restrict__ out, int A,
                                 int N, uint32_t drop_cut,
                                 uint32_t part_cut, uint32_t max_delay,
                                 const unsigned char* __restrict__ flags) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int b = blockIdx.y;
  const bool src_up = !CRASH || !ctt::crash_down(flags, b, N, j);
  const uint32_t sd = seed[b];
  const uint32_t s = static_cast<uint32_t>(j);
  const uint32_t h = ctt::mix_absorb(
      ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), s);
  unsigned char* o = out + (static_cast<long long>(b) * N + j) * A;
  for (int a = 0; a < A; ++a) {
    const int32_t id = ids[b * A + a];
    const uint32_t d = static_cast<uint32_t>(id);
    o[a] = id >= 0 && s != d && src_up &&
           (!CRASH || !ctt::crash_down(flags, b, N, id)) &&
           (ctt::mix_fin(ctt::mix_absorb(h, d)) >= drop_cut ||
            (DELAY &&
             ctt::delayed_open(sd, r, s, d, drop_cut, max_delay))) &&
           same_side(sd, r, part_cut, s, d);
  }
}

}  // namespace

extern "C" int ctt_delivery_edges(const uint32_t* seed, uint32_t r,
                                  const int32_t* ids, unsigned char* out,
                                  int B, int A, int N, uint32_t drop_cut,
                                  uint32_t part_cut, int ids_are_src,
                                  uint32_t max_delay,
                                  const unsigned char* flags,
                                  cudaStream_t st) {
  if (B == 0 || A == 0 || N == 0) return 0;
  const int threads = 256;
  const unsigned gx = (N + threads - 1) / threads;
  const bool delay = max_delay != 0u, crash = flags != nullptr;
  if (ids_are_src) {
    const auto kernel =
        crash ? (delay ? edges_src_kernel<true, true>
                       : edges_src_kernel<false, true>)
              : (delay ? edges_src_kernel<true, false>
                       : edges_src_kernel<false, false>);
    kernel<<<dim3(gx, B * A), threads, 0, st>>>(
        seed, r, ids, out, A, N, drop_cut, part_cut, max_delay, flags);
  } else {
    const auto kernel =
        crash ? (delay ? edges_dst_kernel<true, true>
                       : edges_dst_kernel<false, true>)
              : (delay ? edges_dst_kernel<true, false>
                       : edges_dst_kernel<false, false>);
    kernel<<<dim3(gx, B), threads, 0, st>>>(seed, r, ids, out, A, N,
                                            drop_cut, part_cut, max_delay,
                                            flags);
  }
  return static_cast<int>(cudaGetLastError());
}
