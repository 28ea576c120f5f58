// Kernel KX: one SPEC §7 DPoS round at every validator of each lane: the
// round's producer sends its block, and every validator it reaches appends
// (round, producer) to its chain, in place.
//
// Replaces: consensus_tpu/engines/dpos.py dpos_round (K20, lines 117-180) on
// its flat path, with _producer_delivery (lines 73-92) fused in. Round r's
// producer p is producers[r // epoch_len][(r mod epoch_len) mod K], read on
// the device (the host passes the index). Validator v != p receives the
// block when the delivery mixer's draw of edge p -> v is not below
// drop_cut or (max_delay > 0) a block p sent v in one of the last
// max_delay rounds and lost arrives now (SPEC §A.2, dpos.py lines 83-86:
// K13 delayed_open as ctt::delayed_open, drawn only where the round's own
// draw dropped, in the kernel's DELAY instance, which the launch picks when
// max_delay > 0), and, in a round whose partition is active, v drew p's
// side; p always has it. Unless the round's churn event fires, a receiver
// whose chain is not full writes (r, p) at chain_len[v] and counts it.
//
// Bound: bytes, counting each tensor once: each validator reads and writes
// its chain length (8 bytes) and writes one chain slot where it appends
// (chain_r's and chain_p's element sizes: 3 bytes at dpos-100k), 1.1 MB at
// V = 100 000, 0.33 us at 3.35 TB/s; the function's draws are one mixer
// chain a validator (23 operations) and a few Threefry draws a lane, 0.07
// us at 33.5e12 a second. At that size one launch is dominated by its
// fixed cost (6.2 us in dpos-100k's replay, PERF.md §5).
// Design: one launch, a thread per (lane, validator): the producer's id and
// the lane's churn and partition draws are computed by every thread (a few
// Threefry draws, cheaper than a second launch), the chain slot is written
// at the element size the host passes (uint8, uint16 or int32 storage).
// Where the caller passes n_app (the telemetry's blocks_appended, [B]
// int32, zeroed here), the round's appends are counted too: after an append
// no tensor holds the chain lengths of the round's entry, so the count is
// taken here, by a ballot a warp and shared atomics a block (a block spans
// at most two lanes when V >= 256), then one global atomic a lane a block.
// Its CRASH instances (SPEC §6c, picked when the round's flag word of kernel
// KAH is given) append nothing at a validator down at the round's end, nor
// anywhere in a lane whose round producer is down (dpos.py:171-172).
// Its GATES instances (picked when miss_cut or suppress_cut is non-zero)
// append nothing in a lane whose round producer p misses its slot (SPEC
// §A.1, K13 slot_missed: one draw a (round, producer), dpos.py:139-145)
// or is suppressed in round r's window (SPEC §A.4: one draw a (r / window,
// producer), dpos.py:147-163, 166-169): ctt::slot_missed and
// ctt::suppressed, drawn by each thread after the churn and full-chain
// tests, like churn's lane draw. A cutoff of 0 never fires, so one
// instance serves either gate or both.
// Its KNOBS instances (a knob batch: the table pointer is not null,
// knobs.cuh) read each lane's drop, partition and churn cutoffs and, in a
// GATES instance, its miss and suppress cutoffs from the lane's row of the
// table in place of the arguments. The base's miss and suppress cutoffs
// still pick the GATES instance (dpos.py gated is the base's).
#include <cuda_runtime.h>

#include "crash.cuh"
#include "knobs.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void store(void* base, int size, long long i,
                                      uint32_t x) {
  if (size == 1) {
    static_cast<uint8_t*>(base)[i] = static_cast<uint8_t>(x);
  } else if (size == 2) {
    static_cast<uint16_t*>(base)[i] = static_cast<uint16_t>(x);
  } else {
    static_cast<int32_t*>(base)[i] = static_cast<int32_t>(x);
  }
}

// Validator v of lane b's round: appends (r, p) where the block reaches it,
// and says whether it did.
template <bool DELAY, bool CRASH, bool GATES, bool KNOBS>
__device__ __forceinline__ bool append(
    const uint32_t* __restrict__ seed, uint32_t r,
    const int32_t* __restrict__ producers, void* chain_r, void* chain_p,
    int32_t* __restrict__ chain_len, int r_size, int p_size, int p_index,
    int list_len, uint32_t drop_cut, uint32_t part_cut, uint32_t churn_cut,
    uint32_t max_delay, const unsigned char* __restrict__ flags, int V,
    int L, uint32_t miss_cut, uint32_t suppress_cut, uint32_t window, int b,
    uint32_t v, long long row, const long long* __restrict__ knobs) {
  if (KNOBS) {
    drop_cut = ctt::knob(knobs, b, ctt::KNOB_DROP);
    part_cut = ctt::knob(knobs, b, ctt::KNOB_PARTITION);
    churn_cut = ctt::knob(knobs, b, ctt::KNOB_CHURN);
    if (GATES) {
      miss_cut = ctt::knob(knobs, b, ctt::KNOB_MISS);
      suppress_cut = ctt::knob(knobs, b, ctt::KNOB_SUPPRESS);
    }
  }
  const uint32_t sd = seed[b];
  if (ctt::random_u32(sd, ctt::STREAM_CHURN, r, 0u, 0u) < churn_cut)
    return false;
  const int32_t len = chain_len[row];
  if (len >= L) return false;
  const uint32_t p = static_cast<uint32_t>(
      producers[static_cast<long long>(b) * list_len + p_index]);
  if (GATES && (ctt::slot_missed(sd, r, p, miss_cut) ||
                ctt::suppressed(sd, r, window, p, suppress_cut)))
    return false;
  if (CRASH && (ctt::crash_down(flags, b, V, static_cast<int>(v)) ||
                ctt::crash_down(flags, b, V, static_cast<int>(p))))
    return false;
  if (v != p) {
    const uint32_t h = ctt::mix_absorb(
        ctt::mix_absorb(ctt::mix_absorb(sd ^ ctt::STREAM_DELIVER, r), p), v);
    if (ctt::mix_fin(h) < drop_cut &&
        !(DELAY && ctt::delayed_open(sd, r, p, v, drop_cut, max_delay)))
      return false;
    if (ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 0u, 0u) < part_cut &&
        ((ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 1u, v) ^
          ctt::random_u32(sd, ctt::STREAM_PARTITION, r, 1u, p)) & 1u))
      return false;
  }
  const long long slot = row * L + len;
  store(chain_r, r_size, slot, r);
  store(chain_p, p_size, slot, p);
  chain_len[row] = len + 1;
  return true;
}

// A thread per (lane, validator), flattened.
template <bool DELAY, bool CRASH, bool GATES, bool KNOBS>
__global__ void __launch_bounds__(THREADS)
dpos_round_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                  const int32_t* __restrict__ producers, void* chain_r,
                  void* chain_p, int32_t* __restrict__ chain_len,
                  int32_t* __restrict__ n_app, int r_size, int p_size,
                  int p_index, int list_len, uint32_t drop_cut,
                  uint32_t part_cut, uint32_t churn_cut, uint32_t max_delay,
                  const unsigned char* __restrict__ flags, int V, int L,
                  long long rows, uint32_t miss_cut, uint32_t suppress_cut,
                  uint32_t window, const long long* __restrict__ knobs) {
  __shared__ int s_app[2];
  const long long row =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int b = -1;
  bool did = false;
  if (row < rows) {
    b = static_cast<int>(row / V);
    did = append<DELAY, CRASH, GATES, KNOBS>(
        seed, r, producers, chain_r, chain_p, chain_len, r_size, p_size,
        p_index, list_len, drop_cut, part_cut, churn_cut, max_delay, flags,
        V, L, miss_cut, suppress_cut, window, b,
        static_cast<uint32_t>(row - static_cast<long long>(b) * V), row,
        knobs);
  }
  if (n_app == nullptr) return;
  // The appends a lane, for the telemetry.
  const int b0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  THREADS / V);
  if (threadIdx.x < 2) s_app[threadIdx.x] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
  const int count = __popc(__ballot_sync(0xFFFFFFFFu, did) & peers);
  if (count && (threadIdx.x & 31) == __ffs(peers) - 1) {
    if (b - b0 < 2)
      atomicAdd(&s_app[b - b0], count);
    else
      atomicAdd(n_app + b, count);
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_app[threadIdx.x])
    atomicAdd(n_app + b0 + threadIdx.x, s_app[threadIdx.x]);
}

using RoundKernel = decltype(&dpos_round_kernel<false, false, false, false>);

// The instance of a (DELAY, CRASH) pair with or without the gates and the
// knob table.
template <bool DELAY, bool CRASH>
RoundKernel round_kernel(bool gates, bool kn) {
  return gates ? (kn ? dpos_round_kernel<DELAY, CRASH, true, true>
                     : dpos_round_kernel<DELAY, CRASH, true, false>)
               : (kn ? dpos_round_kernel<DELAY, CRASH, false, true>
                     : dpos_round_kernel<DELAY, CRASH, false, false>);
}

}  // namespace

// n_app is null where the caller does not count the appends. miss_cut and
// suppress_cut are 0 on the flat path (window >= 1 is read only by the
// GATES instances). knobs is a knob batch's [B, 12] table (knobs.cuh; null
// but in a knob batch): the cutoff arguments are then the base's, which
// pick the instance, and each lane reads its own from its row.
extern "C" int ctt_dpos_round(const uint32_t* seed, uint32_t r,
                              const int32_t* producers, void* chain_r,
                              void* chain_p, int32_t* chain_len,
                              int32_t* n_app, int r_size, int p_size,
                              int p_index, int list_len, uint32_t drop_cut,
                              uint32_t part_cut, uint32_t churn_cut,
                              uint32_t max_delay, const unsigned char* flags,
                              int B, int V, int L, uint32_t miss_cut,
                              uint32_t suppress_cut, uint32_t window,
                              const long long* knobs, cudaStream_t st) {
  if (window == 0u) return static_cast<int>(cudaErrorInvalidValue);
  if (n_app != nullptr && B > 0) {
    const int err = static_cast<int>(
        cudaMemsetAsync(n_app, 0, sizeof(int32_t) * B, st));
    if (err != 0) return err;
  }
  const long long rows = static_cast<long long>(B) * V;
  if (rows == 0) return 0;
  const bool delay = max_delay != 0u;
  const bool gates = miss_cut != 0u || suppress_cut != 0u;
  const bool kn = knobs != nullptr;
  const auto kernel =
      flags != nullptr
          ? (delay ? round_kernel<true, true>(gates, kn)
                   : round_kernel<false, true>(gates, kn))
          : (delay ? round_kernel<true, false>(gates, kn)
                   : round_kernel<false, false>(gates, kn));
  kernel<<<static_cast<unsigned>((rows + THREADS - 1) / THREADS), THREADS, 0,
           st>>>(seed, r, producers, chain_r, chain_p, chain_len, n_app,
                 r_size, p_size, p_index, list_len, drop_cut, part_cut,
                 churn_cut, max_delay, flags, V, L, rows, miss_cut,
                 suppress_cut, window, knobs);
  return static_cast<int>(cudaGetLastError());
}
