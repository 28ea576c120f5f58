// Kernel KS: SPEC §6 P6 decide gossip and P7 timers of the dense PBFT round
// at every node of each lane, with the lane's population n_real read per
// lane.
//
// Replaces: consensus_tpu/engines/pbft.py pbft_round (K16) lines 344-366 on
// its flat path, with _adopt_val (lines 96-108), and the same phases of
// consensus_tpu/engines/pbft_sweep.py pbft_round_padded (K17) lines
// 270-281: a slot that receiver j has not committed adopts the decided
// value of the least-id real sender delivered to j that committed it in
// P5 (the min-id decider; _adopt_val's one-hot reduction only keeps a
// gather off the TPU, so the value is read directly here); then a node
// that committed a slot this round, against the round's entry, sets its
// timer to 0, another whose P0-P2 reset it keeps it, and the rest count
// it up.
//
// Bound: bytes, counting each tensor once. Each (node, slot) reads
// committed, dval and the entry's committed and writes committed and dval
// (11 bytes); each node reads its timer and reset flag and writes its
// timer (9 bytes); a real receiver reads its delivery column down to the
// farthest sender any of its undecided slots walks to (its decider, or
// every real sender when none decided). The walks' re-reads of committed
// and dval are not bytes the function must move: a lane's flags are a
// few KB. Operations: about two a walked (sender, slot) pair. At the
// fs = 1..128 ladder's round 20 this is about 7 us; this kernel's warps
// re-read the senders' flags from memory on every walk and take several
// times that (PERF.md §5-§6).
// Design: one launch, a warp per receiver, a thread per slot (32-slot
// chunks). A searching warp walks the real senders in id order, reading
// each one's delivery byte to j once for the warp and its committed flags
// at the warp's slots (coalesced), and a thread stops at its first
// delivered decider; the warp stops when no thread searches. Every output
// is a fresh tensor: an adoption written by one receiver is not read by
// another in the same round. The slot flags that changed against the
// round's entry are OR-ed by a ballot for P7.
// Its BYZ instance (SPEC §3c/§6, picked with byzantine nodes in either
// mode: node i of a lane is honest when i < n_real - nb) walks the honest
// senders only: only honest deciders gossip (pbft.py:347-356).
#include <cuda_runtime.h>

#include <cstdint>

#include "byz.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// A warp per (lane, receiver), flattened.
template <bool HONEST>
__global__ void __launch_bounds__(THREADS)
pbft_decide_kernel(const bool* __restrict__ deliver,
                   const int32_t* __restrict__ n_real,
                   const bool* __restrict__ committed,
                   const int32_t* __restrict__ dval,
                   const bool* __restrict__ committed_start,
                   const int32_t* __restrict__ timer,
                   const bool* __restrict__ reset,
                   bool* __restrict__ com_out, int32_t* __restrict__ dval_out,
                   int32_t* __restrict__ timer_out, int N, int S,
                   long long rows, int nb) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform in the warp
  const int b = static_cast<int>(row / N);
  const int j = static_cast<int>(row - static_cast<long long>(b) * N);
  const long long nodes = static_cast<long long>(b) * N;
  const int n = n_real[b];
  // The senders walked: the real ones, the honest ones (HONEST).
  const int ns = HONEST ? n - nb : n;
  bool changed = false;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    const long long js = row * S + s;
    bool c = in && committed[js];
    int32_t dv = in ? dval[js] : 0;
    // P6: the least-id delivered real decider of slot s.
    bool search = in && !c && j < n;
    for (int i = 0; i < ns && __any_sync(FULL, search); ++i) {
      const bool d = deliver[(nodes + i) * N + j];
      if (search && d) {
        const long long is = (nodes + i) * S + s;
        if (committed[is]) {
          c = true;
          dv = dval[is];
          search = false;
        }
      }
    }
    if (in) {
      com_out[js] = c;
      dval_out[js] = dv;
      changed |= c && !committed_start[js];
    }
  }
  // P7 timers.
  const bool new_commit = __any_sync(FULL, changed);
  if (lane == 0) {
    const int32_t t = timer[row];
    timer_out[row] =
        new_commit ? 0
        : reset[row]
            ? t
            : static_cast<int32_t>(static_cast<uint32_t>(t) + 1u);
  }
}

}  // namespace

extern "C" int ctt_pbft_decide(const bool* deliver, const int32_t* n_real,
                               const bool* committed, const int32_t* dval,
                               const bool* committed_start,
                               const int32_t* timer, const bool* reset,
                               bool* com_out, int32_t* dval_out,
                               int32_t* timer_out, int B, int N, int S,
                               int byz, int nb, cudaStream_t st) {
  if (nb < 0 || nb > N) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long rows = static_cast<long long>(B) * N;
  const unsigned blocks = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
  const auto kernel = byz != ctt::BYZ_NONE ? pbft_decide_kernel<true>
                                           : pbft_decide_kernel<false>;
  kernel<<<blocks, THREADS, 0, st>>>(
      deliver, n_real, committed, dval, committed_start, timer, reset,
      com_out, dval_out, timer_out, N, S, rows, nb);
  return static_cast<int>(cudaGetLastError());
}
